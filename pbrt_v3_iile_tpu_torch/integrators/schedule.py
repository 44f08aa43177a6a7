"""Progressive IILE schedule, precomputed on the host (a copy of the JAX
package's ``integrators/schedule.py``).

Reproduces IisptScheduleMonitor (iisptschedulemonitor.cpp:40-80): tasks
sweep the image in task_size = floor(radius) * NUMBER_TILES squares; when
a sweep completes the radius decays by update_multiplier (default
sqrt(0.79541357), start 100).  The reference's mutex work queue becomes
this precomputed list.
"""

from __future__ import annotations

import dataclasses
import math

NUMBER_TILES = 10  # (ref: iisptschedulemonitor.h:33)


@dataclasses.dataclass(frozen=True)
class Task:
    x0: int
    y0: int
    x1: int
    y1: int
    tilesize: int
    task_number: int
    pass_number: int


def compute_schedule(width: int, height: int, n_tasks: int,
                     radius_start: float = 100.0,
                     update_multiplier: float = math.sqrt(0.79541357)):
    tasks = []
    radius = radius_start
    nextx, nexty = 0, 0
    pass_no = 0
    for tn in range(n_tasks):
        eff = max(1, int(math.floor(radius)))
        task_size = eff * NUMBER_TILES
        x0, y0 = nextx, nexty
        tasks.append(Task(
            x0=x0, y0=y0,
            x1=min(x0 + task_size, width),
            y1=min(y0 + task_size, height),
            tilesize=eff, task_number=tn, pass_number=pass_no,
        ))
        nextx += task_size
        if nextx >= width:
            nextx = 0
            nexty += task_size
        if nexty >= height:
            nexty = 0
            radius *= update_multiplier
            pass_no += 1
    return tasks
