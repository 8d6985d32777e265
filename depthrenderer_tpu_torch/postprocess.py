"""Video post-processing: mosaic grids, concatenation and ground-truth
pairing.

Counterpart of ``depthrenderer_tpu/postprocess.py`` (reference ffmpeg
pipeline ``render_many.py:27-147``): a mosaic grid of every model's video,
a concatenated video, and side-by-side (hstack) videos of each model against
``ground_truth``. Two backends: ``native`` decodes the videos
(:mod:`.video`), composes the frames in numpy on the host and re-encodes
MJPG in the sources' container; ``ffmpeg``, when it is on the host, runs the
reference's filter graphs. ``auto`` picks ffmpeg where it exists.
"""

from __future__ import annotations

import os
import subprocess

import numpy as np

from .io import resize
from .utils import log
from .video import (ffmpeg_available, open_video_writer, read_video_frames,
                    read_video_info)


def _grid_shape(num_sources, num_rows=2):
    return num_rows, -(-num_sources // num_rows)


def _container_ext(video_sources):
    """Native outputs keep the sources' container."""
    return ".mp4" if str(video_sources[0]).lower().endswith(".mp4") else ".avi"


def _use_ffmpeg(backend) -> bool:
    return backend == "ffmpeg" or (backend == "auto" and ffmpeg_available())


def create_mosaic_video(video_sources, output_path, name, source_shape,
                        max_width=1920, fps=None, backend="auto"):
    """Tile every source video into one mosaic video, two rows
    (``render_many.py:80-97``).

    :param source_shape: (height, width) of the source videos.
    :return: the output video path.
    """
    os.makedirs(output_path, exist_ok=True)
    num_rows, num_cols = _grid_shape(len(video_sources))
    output_width = source_shape[1] * num_cols
    output_height = source_shape[0] * num_rows
    aspect = output_width / output_height
    output_width = min(max_width, output_width)
    output_height = int(output_width / aspect)

    if _use_ffmpeg(backend):
        out = os.path.join(output_path, f"{name}.avi")
        _ffmpeg_mosaic(video_sources, out, (output_width, output_height),
                       num_rows, num_cols)
        return out

    out = os.path.join(output_path, f"{name}{_container_ext(video_sources)}")
    cell_w = output_width // num_cols
    cell_h = output_height // num_rows
    decoded = [read_video_frames(src) for src in video_sources]
    if fps is None:
        fps = read_video_info(video_sources[0])[3]
    length = min(len(f) for f in decoded)
    with open_video_writer(out, (cell_w * num_cols, cell_h * num_rows),
                           fps=fps) as writer:
        for t in range(length):
            canvas = np.zeros((cell_h * num_rows, cell_w * num_cols, 3),
                              np.uint8)
            for i, frames in enumerate(decoded):
                r, c = divmod(i, num_cols)
                canvas[r * cell_h:(r + 1) * cell_h,
                       c * cell_w:(c + 1) * cell_w] = resize(
                           frames[t], (cell_h, cell_w))
            writer.write(canvas)
    log(f"Wrote mosaic video {out}")
    return out


def create_concat_video(video_sources, output_path, name, backend="auto"):
    """Concatenate the source videos end to end (``render_many.py:100-115``)."""
    os.makedirs(output_path, exist_ok=True)
    if _use_ffmpeg(backend):
        out = os.path.join(output_path, f"{name}.avi")
        tmp = os.path.join(output_path, "tmp.txt")
        with open(tmp, "w") as f:
            # The concat demuxer's own quoting: single quotes, '\'' escapes.
            f.writelines(
                "file '" + os.path.abspath(p).replace("'", "'\\''") + "'\n"
                for p in video_sources)
        cmd = ["ffmpeg", "-f", "concat", "-safe", "0", "-i", tmp,
               "-c:v", "libx264", out, "-y"]
        log(" ".join(cmd))
        subprocess.run(cmd, check=True)
        os.remove(tmp)
        return out

    out = os.path.join(output_path, f"{name}{_container_ext(video_sources)}")
    w, h, _, fps = read_video_info(video_sources[0])
    with open_video_writer(out, (w, h), fps=fps) as writer:
        for src in video_sources:
            for frame in read_video_frames(src):
                writer.write(frame)
    log(f"Wrote concat video {out}")
    return out


def create_paired_videos(video_sources, output_path, name, model_names,
                         backend="auto"):
    """Side-by-side videos of every model against ``ground_truth``
    (``render_many.py:118-147``) -> their paths."""
    output_path = os.path.join(output_path, name)
    os.makedirs(output_path, exist_ok=True)
    video_sources = list(video_sources)
    model_names = list(model_names)
    if "ground_truth" not in model_names:
        raise RuntimeError(
            "Cannot create paired videos without a ground truth video "
            "present. Make sure a model named 'ground_truth' is included.")
    gt = model_names.index("ground_truth")
    ground_truth_src = video_sources.pop(gt)
    del model_names[gt]

    use_ffmpeg = _use_ffmpeg(backend)
    gt_frames = None if use_ffmpeg else read_video_frames(ground_truth_src)
    ext = ".avi" if use_ffmpeg else _container_ext([ground_truth_src])
    outputs = []
    for model_name, video_source in zip(model_names, video_sources):
        paired = os.path.join(output_path, f"ground_truth-{model_name}{ext}")
        if use_ffmpeg:
            cmd = ["ffmpeg", "-i", str(ground_truth_src), "-i",
                   str(video_source), "-filter_complex", "hstack", paired,
                   "-y"]
            log(" ".join(cmd))
            subprocess.run(cmd, check=True)
        else:
            frames = read_video_frames(video_source)
            w, h, _, fps = read_video_info(video_source)
            with open_video_writer(paired, (2 * w, h), fps=fps) as writer:
                for t in range(min(len(gt_frames), len(frames))):
                    writer.write(np.concatenate([gt_frames[t], frames[t]],
                                                axis=1))
            log(f"Wrote paired video {paired}")
        outputs.append(paired)
    return outputs


def _ffmpeg_mosaic(video_sources, output_path, output_shape, num_rows,
                   num_cols):
    """The reference's nullsrc + overlay filter-graph mosaic
    (``render_many.py:27-97``), run list-form: no shell re-parses the
    paths."""
    input_args = []
    for src in video_sources:
        input_args += ["-i", str(src)]
    output_width, output_height = output_shape
    height = output_height // num_rows
    width = output_width // num_cols
    pieces = [f"nullsrc=size={output_width:d}x{output_height:d} [base]"]
    cells = [(row, col) for row in range(num_rows)
             for col in range(num_cols)][:len(video_sources)]
    for i, (row, col) in enumerate(cells):
        pieces.append(f"[{i}:v] setpts=PTS-STARTPTS, "
                      f"scale={width:d}x{height:d} [{row}x{col}]")
    prev = "base"
    for i, (row, col) in enumerate(cells, start=1):
        piece = (f"[{prev}][{row}x{col}] overlay=shortest=1:"
                 f"x={col * width:d}:y={row * height:d}")
        if i < len(video_sources):
            piece += f" [tmp{i}]"
        pieces.append(piece)
        prev = f"tmp{i}"
    cmd = (["ffmpeg"] + input_args
           + ["-filter_complex", "; ".join(pieces), "-c:v", "libx264",
              output_path, "-y"])
    log(" ".join(cmd))
    subprocess.run(cmd, check=True)
    return output_path
