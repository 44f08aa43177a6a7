"""The port's device scene and its conversion from numpy leaves.

``scene_from_numpy`` takes leaves named as the reference's DeviceScene
fields (for example ``np.asarray`` of each leaf of a JAX DeviceScene,
with the cluster pack as ``clusters.*``, the texture table as
``textures.*`` and the dense Fourier tables as ``fourier.*``) and
returns the port's DeviceScene on a device, so both packages can be fed
the identical scene.  Floats become float32 and
integers int32 at this edge; the scalar counts become python numbers.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional

import numpy as np
import torch

from ..ops.fourierbsdf import FourierDev, fourier_from_numpy
from .api import LIGHT_GONIO, LIGHT_PROJECTION, MAT_HAIR
from .textures import TextureTable, table_from_numpy

# scalar leaves kept as python numbers (read by the host, never synced)
_INT_SCALARS = ("n_spheres", "n_lights", "has_env_map", "env_light_id",
                "bvh4_stack", "camera_medium")
_FLOAT_SCALARS = ("world_radius", "tex_theta")


@dataclass
class ClusterPack:
    """Tables of the fused cluster kernel (triangles in BVH order)."""
    feat: torch.Tensor      # (K, 24, 128) f32 packed edge/plane features
    tri_off: torch.Tensor   # (K,) i32 first triangle id
    tri_cnt: torch.Tensor   # (K,) i32 valid triangles (<= 128)
    aabb_min: torch.Tensor  # (K,3) f32
    aabb_max: torch.Tensor  # (K,3) f32


@dataclass
class DeviceScene:
    # triangles (BVH order)
    tri_p0: torch.Tensor
    tri_e1: torch.Tensor
    tri_e2: torch.Tensor
    tri_ng: torch.Tensor
    tri_ns: torch.Tensor
    tri_uv: torch.Tensor
    tri_mat: torch.Tensor
    tri_light: torch.Tensor
    tri_face: torch.Tensor       # (T,) i32 ptex face index
    # BVH (LinearBVHNode layout) and the packed traversal rows
    node_min: torch.Tensor
    node_max: torch.Tensor
    node_right: torch.Tensor
    node_count: torch.Tensor
    node_axis: torch.Tensor
    nodes_packed: torch.Tensor   # (M,8) i32: bits(min3), bits(max3), right, count<<2|axis
    tris_packed: torch.Tensor    # (T,12) f32: p0, e1, e2, pad
    # the BVH kernel's 4-wide collapse of the same BVH (the port's own;
    # ops/intersect_kernel.py::build_bvh4_np) and its deepest stack
    bvh4_nodes: torch.Tensor     # (W,32) i32
    bvh4_stack: int
    # analytic spheres (padded to >= 1)
    sph_center: torch.Tensor
    sph_radius: torch.Tensor
    sph_mat: torch.Tensor
    sph_light: torch.Tensor
    n_spheres: int
    # materials
    mat_kind: torch.Tensor
    mat_kd: torch.Tensor
    mat_ks: torch.Tensor
    mat_kr: torch.Tensor
    mat_kt: torch.Tensor
    mat_rough: torch.Tensor
    mat_urough: torch.Tensor
    mat_vrough: torch.Tensor
    mat_eta: torch.Tensor
    mat_metal_eta: torch.Tensor
    mat_metal_k: torch.Tensor
    mat_sigma: torch.Tensor
    mat_remap: torch.Tensor
    mat_aux: torch.Tensor
    mat_kd_tex: torch.Tensor
    mat_ks_tex: torch.Tensor
    mat_sigma_tex: torch.Tensor
    mat_rough_tex: torch.Tensor
    mat_sss_d: torch.Tensor      # (M,3) subsurface diffusion length
    mat_fourier_id: torch.Tensor  # (M,) i32 Fourier table or -1
    textures: TextureTable
    # lights
    light_kind: torch.Tensor
    light_L: torch.Tensor
    light_pos: torch.Tensor
    light_dir: torch.Tensor
    light_cos_total: torch.Tensor
    light_cos_falloff: torch.Tensor
    light_two_sided: torch.Tensor
    light_sphere: torch.Tensor
    light_tri_off: torch.Tensor
    light_tri_cnt: torch.Tensor
    light_area: torch.Tensor
    light_pdf: torch.Tensor
    light_cdf: torch.Tensor
    n_lights: int
    # goniometric / projection lights: rotations and stacked direction maps
    light_w2l: torch.Tensor      # (L,3,3) world-to-light rotation
    light_img: torch.Tensor      # (G,MH,MW,3)
    light_img_id: torch.Tensor   # (L,) i32 map index or -1
    light_proj_ax: torch.Tensor  # (L,) projection window half extents
    light_proj_ay: torch.Tensor
    ltri_p0: torch.Tensor
    ltri_e1: torch.Tensor
    ltri_e2: torch.Tensor
    ltri_ng: torch.Tensor
    ltri_area: torch.Tensor
    ltri_cdf: torch.Tensor
    ltri_light: torch.Tensor
    # participating media (at least one slot each)
    med_sigma_a: torch.Tensor     # (D,3)
    med_sigma_s: torch.Tensor     # (D,3)
    med_g: torch.Tensor           # (D,) Henyey-Greenstein g
    med_grid_id: torch.Tensor     # (D,) i32 density grid or -1
    med_w2m: torch.Tensor         # (D,4,4) world to medium (unit cube)
    med_density: torch.Tensor     # (G,DZ,DY,DX) padded density grids
    med_grid_dims: torch.Tensor   # (G,3) i32 (nx, ny, nz) of each grid
    med_max_density: torch.Tensor  # (D,) the grid's majorant (1 if none)
    tri_med_in: torch.Tensor      # (T,) i32 inside medium or -1, BVH order
    tri_med_out: torch.Tensor     # (T,) i32 outside medium or -1
    camera_medium: int
    # environment map
    env_img: torch.Tensor
    env_marg_cdf: torch.Tensor
    env_cond_cdf: torch.Tensor
    env_pdf: torch.Tensor
    env_to_world: torch.Tensor
    env_world_to: torch.Tensor
    has_env_map: int
    env_light_id: int
    # world, spatial light grid, ray-cone texture filter
    world_min: torch.Tensor
    world_max: torch.Tensor
    spatial_pdf: torch.Tensor
    spatial_cdf: torch.Tensor
    spatial_res: torch.Tensor
    world_radius: float
    tri_uv_density: torch.Tensor
    tex_theta: float
    tex_cone_o: torch.Tensor
    # object motion blur: M sub-keyframes of every triangle (BVH order),
    # piecewise-lerped at each ray's time; (1, 1, ...) in a static scene
    tris_steps_packed: torch.Tensor  # (M,T,12) f32: p0, e1, e2, pad
    tri_ng_steps: torch.Tensor       # (M,T,3)
    tri_ns_steps: torch.Tensor       # (M,T,3,3)
    # the kd-tree of the "kdtree" accel over the same triangles (one empty
    # leaf when the scene was built without it)
    kd_split: torch.Tensor    # (K,) f32
    kd_meta: torch.Tensor     # (K,) i32: axis (3 = leaf) | count << 2
    kd_offset: torch.Tensor   # (K,) i32: above child, or a leaf's first prim
    kd_prims: torch.Tensor    # (P,) i32
    kd_bounds: torch.Tensor   # (2,3) f32
    clusters: Optional[ClusterPack] = None
    fourier: Optional[FourierDev] = None   # None: no Fourier material

    def __post_init__(self):
        # read once: whether a light carries a goniometric or projection
        # map, so that light sampling skips the map lookups otherwise
        kinds = set(self.light_kind[:self.n_lights].cpu().tolist())
        self.has_map_lights = bool(kinds & {LIGHT_GONIO, LIGHT_PROJECTION})
        # ... and whether a material is hair, so that BSDF evaluation
        # skips the fiber lobe otherwise
        self.has_hair = bool((self.mat_kind == MAT_HAIR).any())
        # ... and whether the kd-tree was built
        self.has_kdtree = bool(self.kd_bounds.abs().sum() > 0)

    def leaves(self) -> dict:
        """Every leaf as numpy, under the reference's names."""
        out = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if f.name == "textures":
                out.update({k: t.cpu().numpy() for k, t in v.leaves().items()})
            elif f.name in ("clusters", "fourier"):
                if v is not None:
                    out.update({f"{f.name}.{g.name}":
                                getattr(v, g.name).cpu().numpy()
                                for g in fields(v)})
            elif isinstance(v, torch.Tensor):
                out[f.name] = v.cpu().numpy()
            elif f.name in _INT_SCALARS:
                out[f.name] = np.asarray(v, np.int32)
            else:
                out[f.name] = np.asarray(v, np.float32)
        return out


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype.kind in "iub":
        t = torch.as_tensor(a.astype(np.int32), device=device)
        assert t.dtype == torch.int32
    else:
        t = torch.as_tensor(a.astype(np.float32), device=device)
        assert t.dtype == torch.float32
    return t.contiguous()


def scene_from_numpy(leaves: dict, device) -> DeviceScene:
    """Numpy leaves (reference names) -> DeviceScene on ``device``."""
    device = torch.device(device)
    kw = {}
    for f in fields(DeviceScene):
        name = f.name
        if name == "textures":
            tex = {k.split(".", 1)[1]: v for k, v in leaves.items()
                   if k.startswith("textures.")}
            kw[name] = table_from_numpy(tex, device)
        elif name == "clusters":
            if "clusters.feat" in leaves:
                kw[name] = ClusterPack(**{
                    g.name: _tensor(leaves[f"clusters.{g.name}"], device)
                    for g in fields(ClusterPack)})
        elif name == "fourier":
            if "fourier.mu" in leaves:
                kw[name] = fourier_from_numpy(
                    {k.split(".", 1)[1]: v for k, v in leaves.items()
                     if k.startswith("fourier.")}, device)
        elif name in _INT_SCALARS:
            kw[name] = int(np.asarray(leaves[name]))
        elif name in _FLOAT_SCALARS:
            kw[name] = float(np.float32(leaves[name]))
        else:
            kw[name] = _tensor(leaves[name], device)
    return DeviceScene(**kw)

