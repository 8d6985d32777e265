"""The benchmark of the PyTorch and CUDA port (``depthrenderer_tpu_torch``).

Run a cell with ``python benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the repository's root; see README.md.
"""
