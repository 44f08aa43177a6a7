"""One configuration dataclass for the whole framework (a copy of the JAX
package's ``utils/config.py``, which imports no jax).

Collapses the reference's three config tiers — CLI-parsed global `Options`
(ref: src/core/pbrt.h:166), tuning environment variables (ref: Doc.md
"Environment Variables"), and per-run knobs — into a single explicit object.
Scene-level parameters still come from the .pbrt file.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class RenderOptions:
    # --- mirrors of reference Options (pbrt.h:166) ---
    n_threads: int = 0                 # 0 = all devices (was: CPU threads)
    quick_render: bool = False
    image_file: str = ""
    # IILE knobs
    iispt_hemi_size: int = 32          # probe G-buffer resolution
    iile_indirect_tasks: int = 16      # number of indirect tasks (passes)
    iile_direct_samples: int = 16      # progressive direct 1spp passes
    reference_tiles: int = 16          # training-data probe grid
    reference_pixel_samples: int = 4096
    iile_d_sampler: str = "random"     # sampler for probe renders
    iile_control: str = ""             # progressive-preview output directory
    # --- schedule (ref: iisptschedulemonitor.cpp:13-32, env vars) ---
    schedule_radius_start: float = 100.0
    schedule_radius_ratio: float = 0.8918596  # sqrt(0.79541357)
    # --- sampling / integration ---
    seed: int = 0
    max_depth: int = 5
    rr_threshold: float = 1.0
    # --- wavefront sizing (TPU-specific; no reference analogue) ---
    rays_per_wave: int = 1 << 17       # rays per jitted wavefront launch
    spp_per_pass: int = 1              # samples-per-pixel per device pass
    # --- sharding ---
    mesh_shape: tuple = ()             # e.g. (("tile", 4), ("batch", 2))
    # --- output ---
    write_partial_every: int = 0       # progressive preview cadence (passes)
