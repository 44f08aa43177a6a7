"""Sharded render pass, data-parallel train step and geometry sharding
over the process group (port of ``parallel/sharded.py``).

Mappings (the reference's parallel pieces):
  tile data-parallelism     -> image rows split into shards, gathered
  shared mutable film       -> one row block a shard, no shared writes
  training data-parallel    -> the global batch split over the ranks,
                               BatchNorm statistics and gradients
                               all-reduced
  scenes beyond one device  -> triangles split over shards, each with its
                               own BVH, the closest hit reduced

Every function splits its work into ``n_shards`` shards (default: the
world size; ``parallel/mesh.py``), runs this rank's shards in order and
gathers the results to every rank in shard order.  Without a process
group one process runs every shard, which is how the tests hold a world
of processes to the same function run in one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from . import distributed
from . import mesh as meshlib


def all_gather_cat(x, group=None):
    """``x`` of every rank (one shape on all) concatenated on its first
    axis in rank order; ``x`` itself without a process group.  Booleans
    travel as bytes (gloo's support for them is uneven)."""
    if not dist.is_initialized():
        return x
    is_bool = x.dtype == torch.bool
    if is_bool:
        x = x.to(torch.uint8)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts)
    return out.bool() if is_bool else out


def all_reduce_sum(x, group=None):
    """The sum of ``x`` over the ranks (``x`` without a process group)."""
    if dist.is_initialized():
        x = x.clone()
        dist.all_reduce(x, group=group)
    return x


# ---------------------------------------------------------------------------
# the row-sharded render pass
# ---------------------------------------------------------------------------

def sharded_render_pass(sd, cfg=None, device="cuda", n_shards: int = None,
                        group=None):
    """f(scene, cam, key, pass_idx) -> (L (H, W, 3), jitter (H, W, 2), aux)
    with the image's rows split into n_shards row blocks.  Shard s is the
    port's ``render_pass_fn`` at chunk_rows = H / n_shards and row0 = s *
    H / n_shards, so the pass equals the chunked render bit for bit; the
    rows are gathered to every rank.  aux["rays"] counts every shard's
    rays; for ``bdpt`` aux["splat"] is the sum of the shards' light-tracing
    films.  cfg: the integrator config (default: the scene's, on the
    accel ``make_integrator_config`` resolves for ``device``)."""
    from ..integrators import render as renderlib

    n = meshlib.resolve_shards(n_shards, group)
    H = sd.film.y_resolution
    if cfg is None:
        cfg = renderlib.make_integrator_config(sd, device=device)
    rows0 = [meshlib.row_block(H, n, s)[0] for s in meshlib.my_shards(n, group)]
    run1 = renderlib.render_pass_fn(sd, cfg, device, chunk_rows=H // n)

    def run(scene, cam, key, pass_idx: int):
        Ls, Js, rays, splat = [], [], 0, None
        for row0 in rows0:
            L, jitter, aux = run1(scene, cam, key, pass_idx, row0)
            Ls.append(L)
            Js.append(jitter)
            rays = rays + aux["rays"]
            if "splat" in aux:
                splat = aux["splat"] if splat is None else splat + aux["splat"]
        out = {"rays": all_reduce_sum(torch.as_tensor(rays, device=L.device),
                                      group)}
        if splat is not None:
            out["splat"] = all_reduce_sum(splat, group)
        return (all_gather_cat(torch.cat(Ls), group),
                all_gather_cat(torch.cat(Js), group), out)

    return run


# ---------------------------------------------------------------------------
# the data-parallel train step
# ---------------------------------------------------------------------------

def make_train_step(net, optimizer, loss: str = "l1", group=None):
    """step(x, y) -> loss: this rank's rows of the global batch (equal
    shares; ``mesh.batch_slice``) through the training-mode forward pass
    with BatchNorm's statistics taken over the global batch, the backward
    pass, the gradients averaged over the ranks, and one optimizer step;
    the loss returned is the global batch's mean.  That is what XLA
    computes from the JAX package's shardings (one global-view program).
    Without a process group it is ``ml/train.py``'s one-device step."""
    from ..ml import losses as losslib
    from ..ml import train as trainlib
    from ..models import iisptnet

    if not dist.is_initialized():
        return trainlib.make_train_step(net, optimizer, loss)
    loss_f = losslib.get(loss)
    params = [p for p in net.parameters() if p.requires_grad]
    world = dist.get_world_size(group)

    def step(x, y):
        net.train()
        with iisptnet.fp32_convolutions(x.device):
            with iisptnet.synced_batchnorm(net, group):
                value = loss_f(net(x), y)
            optimizer.zero_grad(set_to_none=True)
            value.backward()
            flat = torch.cat([p.grad.reshape(-1) for p in params])
            dist.all_reduce(flat, group=group)
            flat /= world
            for p, g in zip(params, flat.split([p.numel() for p in params])):
                p.grad.copy_(g.view_as(p))
            optimizer.step()
        return all_reduce_sum(value.detach(), group) / world

    return step


# ---------------------------------------------------------------------------
# geometry sharding
# ---------------------------------------------------------------------------

@dataclass
class GeometryShard:
    """One shard's triangles and their BVH, as the BVH kernel reads them."""
    shard: int
    bvh4_nodes: torch.Tensor   # (W, 32) i32, ``build_bvh4_np``'s wide nodes
    bvh4_stack: int            # its stack bound
    tris_packed: torch.Tensor  # (T_s, 12) f32 in the shard's BVH order
    global_id: torch.Tensor    # (T_s,) i32 each triangle's id in the scene


def shard_scene_geometry(scene, n_shards: int = None, group=None):
    """Split the scene's triangles over n_shards shards for scenes whose
    BVH exceeds one device (the reference's MOD/MATCH split, iispt.cpp:
    479-505, applied to geometry): shard k takes every triangle t with t %
    n_shards == k and gets its own BVH from the numpy builder, collapsed
    to the BVH kernel's 4-wide nodes.  Lights, materials and textures stay
    with the replicated scene.  Returns this rank's shards."""
    from ..ops import bvh as bvhlib
    from ..ops.intersect_kernel import build_bvh4_np, pack_nodes_np

    n = meshlib.resolve_shards(n_shards, group)
    dev = scene.tri_p0.device
    p0, e1, e2 = (x.cpu().numpy() for x in (scene.tri_p0, scene.tri_e1,
                                           scene.tri_e2))
    T = p0.shape[0]
    tri_p = np.stack([p0, p0 + e1, p0 + e2], axis=1)   # (T, 3, 3)
    packed = np.zeros((T, 12), np.float32)
    packed[:, 0:3], packed[:, 3:6], packed[:, 6:9] = p0, e1, e2
    shards = []
    for k in meshlib.my_shards(n, group):
        ids = np.arange(k, T, n)
        if ids.size:
            sub_p, tris, gids = tri_p[ids], packed[ids], ids
        else:   # a degenerate triangle, which no ray hits
            sub_p = np.zeros((1, 3, 3), np.float32)
            tris, gids = np.zeros((1, 12), np.float32), np.zeros(1, np.int64)
        flat = bvhlib.build_bvh(sub_p, use_native=False)
        order = flat.prim_order
        wide, stack = build_bvh4_np(pack_nodes_np(flat))
        shards.append(GeometryShard(
            shard=k, bvh4_nodes=torch.as_tensor(wide, device=dev),
            bvh4_stack=int(stack),
            tris_packed=torch.as_tensor(np.ascontiguousarray(tris[order]),
                                        device=dev),
            global_id=torch.as_tensor(gids[order].astype(np.int32),
                                      device=dev)))
    return shards


def sharded_geometry_intersect(shards, o, d, t_max, group=None):
    """Closest hit of every ray against geometry split by
    ``shard_scene_geometry``: each rank traverses the whole wave against
    its shards with the BVH kernel (K2; its plain version on CPU
    tensors), the shards' (t, global id, b1, b2) are gathered in shard
    order, and the least t wins, a tie to the lower shard.  Returns an
    ``ops/intersect.py`` Hit whose prim is the scene's triangle id (-1 and
    t = t_max on a miss), so ``make_interaction`` reads the replicated
    scene.  The id travels as int32, exact at any triangle count."""
    from ..ops import intersect_kernel as K2
    from ..ops.intersect import Hit

    o, d, t_max = o.contiguous(), d.contiguous(), t_max.contiguous()
    parts = []
    for g in shards:
        if o.device.type == "cuda":
            t, prim, b1, b2 = K2.bvh_traverse_cuda(
                g.bvh4_nodes, g.bvh4_stack, g.tris_packed, o, d, t_max)
        else:
            t, prim, b1, b2 = K2.bvh_traverse_wide_plain(
                g.bvh4_nodes, g.tris_packed, o, d, t_max)
        hit = prim >= 0
        t = torch.where(hit, t, math.inf)
        gid = torch.where(hit, g.global_id[prim.clamp(min=0).long()], -1)
        parts.append(torch.stack([t.view(torch.int32), gid,
                                  b1.view(torch.int32), b2.view(torch.int32)],
                                 dim=-1))
    every = all_gather_cat(torch.stack(parts), group)       # (n, N, 4) i32
    best = torch.argmin(every[..., 0].view(torch.float32), dim=0)
    sel = every.gather(0, best[None, :, None].expand(1, -1, 4))[0]
    t_best = sel[:, 0].view(torch.float32)
    valid = torch.isfinite(t_best)
    return Hit(t=torch.where(valid, t_best, t_max),
               prim=torch.where(valid, sel[:, 1], -1),
               b1=sel[:, 2].view(torch.float32),
               b2=sel[:, 3].view(torch.float32), valid=valid)
