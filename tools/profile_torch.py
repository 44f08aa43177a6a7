"""Profile the PyTorch port on one NVIDIA GPU: device-busy time and idle
share of five runs, each timed unprofiled and then run once under
torch.profiler.

Run from the repository root on a machine with a GPU:

    python3 tools/profile_torch.py

Sessions (one line each, ``[name] {json}``, as ``chip_smoke.py`` printed
them before they moved here; each profiler table, the 40 rows of most
device time, goes to ``chiprun_out/<table>.txt``):
  - ``profile_atrium512_pass_clusters``: the atrium 512^2 depth-5
    compacted pass as bench.py configures it, on ``clusters`` (after a
    warmup and 4 timed passes, whose median is the unprofiled time);
  - ``profile_transport512_all`` and its ``_tracking`` line: the
    ``scenes/atrium_transport.pbrt`` 512^2 volpath pass with the smoke on
    ``clusters`` (after a warmup and 3 timed passes), with the delta- and
    ratio-tracking loops in record_function spans: their calls, kernel
    launches, kernel ms, device span and host ms;
  - ``profile_mlt512_step``: one BDPT-MLT chain step at atrium 512^2 (the
    file's depth 6, 1,024 chains from the bootstrap of 4,096 samples),
    after MLT_STEPS timed steps;
  - ``profile_iile512_task0``: the first task of the 512^2 IILE render at
    the CLI's defaults (121 probes of 32^2, the committed net, clusters);
  - ``profile_train_10_steps``: 10 full-width train steps (batch 32) on a
    batch of interior_v1 probes generated at TRAIN_GEN.

Device-busy ms is the sum of the device events' self time (the rows of
kernels and copies; an operator's row repeats its kernels' time, and the
record_function spans are ranges, not kernels); the idle share is one
minus that over the unprofiled wall time.  The last line is nvidia-smi's
name and power limit.  Exits non-zero without a GPU.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402  (its helpers and settings; imports no jax)

N_PASS = 4   # timed passes before the profiled one


def profiled(name, fn, unprofiled_s, table_file, keys, smi, spans=()):
    """Device-busy ms of one run of fn under torch.profiler (the rows of
    device events only: an operator's row repeats the time of the kernels
    it launched, and the device rows of the record_function spans named in
    ``spans`` are ranges, not kernels) and the idle share against
    unprofiled_s; the profiled and unprofiled ms are printed under the
    names in keys, the profiler's table goes to OUT_DIR/table_file.
    Returns the profile."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        prof_s = time.time() - t0
    averages = prof.key_averages()
    with open(os.path.join(cs.OUT_DIR, table_file), "w") as f:
        f.write(averages.table(sort_by="cuda_time_total", row_limit=40))
    evs = [e for e in averages
           if e.device_type == DeviceType.CUDA and e.key not in spans]
    dev_us = sum(e.self_device_time_total for e in evs)
    cs.check(dev_us > 0, "the profiler saw no device time")
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:8]
    cs.line(name, device_busy_ms=dev_us / 1e3,
            device_events=sum(e.count for e in evs),
            **{keys[0]: prof_s * 1e3, keys[1]: unprofiled_s * 1e3},
            idle_share=1.0 - dev_us / 1e6 / unprofiled_s,
            idle_share_profiled=1.0 - dev_us / 1e6 / prof_s,
            top=[(e.key[:60], e.count, round(e.self_device_time_total / 1e3, 3))
                 for e in top], power=smi)
    return prof


def timed(fn, reps):
    """Wall seconds of each of reps synced runs of fn."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        out.append(time.time() - t0)
    return out


def atrium512(dev):
    from pbrt_v3_iile_tpu_torch.integrators import render as renderlib
    from pbrt_v3_iile_tpu_torch.scene import api as apilib

    sd = apilib.load_scene(os.path.join(REPO, "scenes", "atrium.pbrt"))
    sd.film.x_resolution = sd.film.y_resolution = 512
    scene, cam = renderlib.build(sd, dev, with_clusters=True)
    return sd, scene, cam


def pass_session(dev, smi, atrium):
    """The main path's pass on its default accel, timed; returns its
    profile step (each session below likewise)."""
    from pbrt_v3_iile_tpu_torch.integrators import render as renderlib
    from pbrt_v3_iile_tpu_torch.ops import threefry

    sd, scene, cam = atrium
    cfg = renderlib.make_integrator_config(sd, accel="clusters", device=dev)
    cfg = cfg.replace(max_depth=5, compact_schedule=renderlib.COMPACT_SCHEDULE)
    run = renderlib.render_pass_fn(sd, cfg, dev)
    key = threefry.prng_key(0)
    float(run(scene, cam, key, 0)[0].sum())             # warmup pass
    p = iter(range(1, N_PASS + 1))
    times = timed(lambda: float(run(scene, cam, key, next(p))[0].sum()), N_PASS)
    return lambda: profiled(
        "profile_atrium512_pass_clusters",
        lambda: float(run(scene, cam, key, N_PASS + 1)[0].sum()),
        float(np.median(times)), "profile_atrium512_clusters.txt",
        ("profiled_pass_ms", "median_pass_ms"), smi)


def transport_session(dev, smi):
    """The atrium_transport pass with the smoke, with the tracking loops'
    spans: their calls, kernel launches, device and host ms."""
    from torch.autograd import DeviceType

    from pbrt_v3_iile_tpu_torch.integrators import path as pathlib_
    from pbrt_v3_iile_tpu_torch.integrators import render as renderlib
    from pbrt_v3_iile_tpu_torch.ops import threefry
    from pbrt_v3_iile_tpu_torch.scene import api as apilib

    tool = cs.transport_tool()
    scene_file = os.path.join(REPO, "scenes", "atrium_transport.pbrt")
    sd = apilib.load_scene_string(tool.variant(open(scene_file).read(), tool.FEATURES),
                                  os.path.dirname(scene_file))
    cfg = renderlib.make_integrator_config(sd, accel="clusters", device=dev)
    scene, cam = renderlib.build(sd, dev, with_clusters=True)
    run = renderlib.render_pass_fn(sd, cfg, dev)
    key = threefry.prng_key(0)
    float(run(scene, cam, key, 0)[0].sum())             # warmup pass
    p = iter(range(1, 4))
    med_s = float(np.median(timed(
        lambda: float(run(scene, cam, key, next(p))[0].sum()), 3)))

    inner = (pathlib_._delta_track, pathlib_._ratio_track)

    def spanned(span, fn):
        def wrap(*a, **kw):
            with torch.profiler.record_function(span):
                return fn(*a, **kw)
        return wrap

    def profile():
        pathlib_._delta_track = spanned("delta_track", inner[0])
        pathlib_._ratio_track = spanned("ratio_track", inner[1])
        try:
            prof = profiled("profile_transport512_all",
                            lambda: float(run(scene, cam, key, 4)[0].sum()),
                            med_s, "profile_transport512_all.txt",
                            ("profiled_pass_ms", "median_pass_ms"), smi,
                            spans=("delta_track", "ratio_track"))
        finally:
            pathlib_._delta_track, pathlib_._ratio_track = inner
        spans = {}
        for sp in ("delta_track", "ratio_track"):
            host = [e for e in prof.events() if e.name == sp
                    and e.device_type == DeviceType.CPU]
            ranges = [e for e in prof.events() if e.name == sp
                      and e.device_type == DeviceType.CUDA]
            launches, stack = 0, [c for e in host for c in e.cpu_children]
            while stack:
                e = stack.pop()
                launches += e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                       "cuLaunchKernel", "cuLaunchKernelEx")
                stack.extend(e.cpu_children)
            # kernel time launched inside the span, the span's extent on
            # the device timeline, and its host time
            spans[sp] = dict(
                calls=len(host), launches=launches,
                device_kernel_ms=sum(e.device_time_total for e in host) / 1e3,
                device_span_ms=sum(e.time_range.elapsed_us() for e in ranges) / 1e3,
                host_ms=sum(e.cpu_time_total for e in host) / 1e3)
        cs.line("profile_transport512_all_tracking", power=smi, **spans)

    return profile


def mlt_session(dev, smi, atrium):
    """One BDPT-MLT chain step from the chain starts of the bootstrap."""
    from pbrt_v3_iile_tpu_torch.integrators import mlt as mltlib
    from pbrt_v3_iile_tpu_torch.ops import camera as camlib
    from pbrt_v3_iile_tpu_torch.ops import threefry
    from pbrt_v3_iile_tpu_torch.utils import vecmath as vm

    sd, scene, _ = atrium
    H = W = cs.BIDIR_FILM
    cam = camlib.make_camera(sd.camera, sd.film, dev)
    depth = sd.integrator.max_depth
    mcfg = mltlib.MLTConfig(max_depth=depth)
    eval_fn = lambda u: mltlib._eval_bdpt(scene, cam, 0, False, u, depth)
    k_boot, k_sel, k_run = threefry.split(threefry.prng_key(0), 3)
    u_boot = threefry.uniform(k_boot, (mcfg.n_bootstrap, mltlib._dims(mcfg)), dev)
    L_boot, _ = eval_fn(u_boot)
    I_boot = vm.luminance(torch.abs(L_boot))
    u0 = u_boot[threefry.categorical(k_sel, threefry.xla_log(
        torch.clamp(I_boot, min=1e-20)), (mcfg.n_chains,))]
    L0, xy0 = eval_fn(u0)
    chain = (u0, L0, vm.luminance(torch.abs(L0)), xy0)
    step_keys = threefry.split(k_run, cs.MLT_STEPS)
    film = torch.zeros((H * W, 3), device=dev)

    def steps(chain, keys):
        for k in keys:
            chain = mltlib.chain_step(eval_fn, chain, k, mcfg, film, H, W)
        return chain

    torch.cuda.synchronize()
    t0 = time.time()
    chain = steps(chain, step_keys)
    torch.cuda.synchronize()
    step_s = (time.time() - t0) / cs.MLT_STEPS
    cs.check(bool(torch.isfinite(film).all()), "mlt512: non-finite film")
    return lambda: profiled(
        "profile_mlt512_step", lambda: steps(chain, step_keys[:1]), step_s,
        "profile_mlt512_step.txt", ("profiled_step_ms", "unprofiled_step_ms"), smi)


def iile_session(dev, smi, atrium):
    """The first task of the full-width IILE render (4 chunks of 65,536
    pixels)."""
    from pbrt_v3_iile_tpu_torch.integrators import iispt, schedule
    from pbrt_v3_iile_tpu_torch.models import weights
    from pbrt_v3_iile_tpu_torch.ops import threefry

    sd, scene, cam = atrium
    net = weights.load_iisptnet(device=dev)
    task = schedule.compute_schedule(512, 512, 1)[0]
    tkey = threefry.fold_in(threefry.prng_key(0), 1000)
    first_task = lambda: iispt.run_task(scene, cam, sd, net, tkey, task,
                                        accel="clusters")
    (unprofiled_s,) = timed(first_task, 1)
    return lambda: profiled(
        "profile_iile512_task0", first_task, unprofiled_s,
        "profile_iile512_task0.txt", ("profiled_task_ms", "unprofiled_task_ms"), smi)


def train_session(dev, smi):
    """10 full-width train steps on one batch of interior_v1 probes."""
    from pbrt_v3_iile_tpu_torch.cli import train as clitrain
    from pbrt_v3_iile_tpu_torch.integrators import render as renderlib
    from pbrt_v3_iile_tpu_torch.ml import dataset as datasetlib
    from pbrt_v3_iile_tpu_torch.ml import train as trainlib
    from pbrt_v3_iile_tpu_torch.ops import camera as camlib
    from pbrt_v3_iile_tpu_torch.ops import threefry

    gen = cs.TRAIN_GEN
    sd = clitrain.load_named_scene("interior_v1")
    scene, cam = renderlib.build(sd, dev, with_clusters=True)
    coords = clitrain.probe_grid(sd.film.x_resolution, sd.film.y_resolution,
                                 gen["grid"])
    maps = datasetlib.generate_examples(
        scene, cam, camlib.KIND.get(sd.camera.kind, 0), threefry.prng_key(1),
        torch.as_tensor(coords, device=dev), hemi_size=gen["hemi"],
        gt_spp=gen["gt_spp"], accel="clusters")
    m = {k: v.cpu().numpy() for k, v in maps.items()}
    raws = [{k: m[k][i] for k in "pdnz"} for i in range(len(coords)) if m["valid"][i]]
    x, y = next(datasetlib.batches_from_raw(raws, trainlib.BATCH_SIZE,
                                            threefry.prng_key(2), device=dev))
    state = trainlib.init_training(torch.Generator().manual_seed(0),
                                   hemi_size=gen["hemi"], device=dev)
    ten_steps = lambda: [state["step"](x, y) for _ in range(10)]
    ten_steps()                                          # warmup
    (unprofiled_s,) = timed(ten_steps, 1)
    return lambda: profiled(
        "profile_train_10_steps", ten_steps, unprofiled_s,
        "profile_train_10_steps.txt",
        ("profiled_10_steps_ms", "unprofiled_10_steps_ms"), smi)


def main():
    t_start = time.time()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this tool needs a GPU")
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0] if smi else "unavailable"
    atrium = atrium512(dev)
    # every unprofiled run comes first: a profiler session leaves tracing
    # overhead on the launches that follow it
    profiles = [pass_session(dev, smi, atrium), transport_session(dev, smi),
                mlt_session(dev, smi, atrium), iile_session(dev, smi, atrium),
                train_session(dev, smi)]
    cs.line("profile_torch_timed", wall_seconds=time.time() - t_start)
    for profile in profiles:
        profile()
    cs.line("profile_torch", wall_seconds=time.time() - t_start)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
