"""The seeded scenes: deterministic for a seed, geometry that differs
between seeds, depth within the class the port's smoke renders."""

import numpy as np

from benchmark import scenes


def test_same_seed_same_scene():
    a = scenes.make_scene(2**31 + 7, 3, 72, 128)
    b = scenes.make_scene(2**31 + 7, 3, 72, 128)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_depth_differs_between_seeds_and_scenes():
    d0 = scenes.make_scene(11, 0, 72, 128)[1]
    d1 = scenes.make_scene(12, 0, 72, 128)[1]
    d2 = scenes.make_scene(11, 1, 72, 128)[1]
    assert (d0 != d1).mean() > 0.3 and (d0 != d2).mean() > 0.3


def test_scene_class():
    for seed in range(5):
        colour, depth = scenes.make_scene(seed, 0, 72, 128)
        assert colour.shape == (72, 128, 4) and colour.dtype == np.uint8
        assert (colour[..., 3] == 255).all()
        assert depth.shape == (72, 128) and depth.dtype == np.uint8
        assert 20 <= depth.min() and depth.max() <= 240
        assert (depth == 20).any()   # the near disc
