"""A configuration's box room rendered from `n` cameras on its orbit, as
JPEGs `img0000.jpg` ... in orbit order, by `WORKERS` processes in set-up
(each builds the room's textures once, on every core the process was
given before `env.pin`).  The views are those of `room.render_box_room`
at the same sizes and texture seed."""

from __future__ import annotations

import multiprocessing
import os

import numpy as np

from sfmbench import env
from sfmbench.gen import room

WORKERS = 4
_SCENE = {}


def _build(cores, W, H, f, scene_seed, sheet_size):
    os.sched_setaffinity(0, cores)
    rng = np.random.default_rng(scene_seed)
    planes = room.plane_corners()
    _SCENE.update(W=W, H=H, f=f, planes=planes,
                  sheets=[room.texture_sheet(sheet_size, rng)
                          for _ in planes])


def _render(job):
    i, n, path = job
    R, c = room.camera(i, n)
    s = _SCENE
    room.render_view(R, c, s["f"], s["W"], s["H"], s["planes"],
                     s["sheets"]).save(path, quality=92)


def render(config, n: int, out_dir: str) -> np.ndarray:
    """Write the `n` views into `out_dir`; returns their centres [n, 3].
    The worker processes are joined before it returns."""
    os.makedirs(out_dir)
    cores = env.HOST_CORES or sorted(os.sched_getaffinity(0))
    args = (cores, int(config["width"]), int(config["height"]),
            float(config["focal"]), int(config["scene_seed"]),
            int(config["sheet_size"]))
    jobs = [(i, n, os.path.join(out_dir, f"img{i:04d}.jpg"))
            for i in range(n)]
    pool = multiprocessing.get_context("spawn").Pool(
        min(WORKERS, n), initializer=_build, initargs=args)
    try:
        pool.map(_render, jobs, chunksize=1)
    finally:
        pool.close()
        pool.join()
    return np.array([room.camera(i, n)[1] for i in range(n)])

