"""Scene checkpoints: save a built ``RayScene`` and load it without a
new BVH build.

PyTorch counterpart of the JAX package's scene/serialize.py and its .npz
format v2.  The file holds the slot-ordered triangles, the BVH with its
per-depth ``levels`` and the backend; the cast tables are derived state
that ``load_scene`` rebuilds from them with the port's builders (the
cluster cut and wide collapse are cheap next to a BVH build).  A refit
keeps the build's 8-wide grouping while a new collapse over the refit
boxes could group differently, so the port also stores the grouping it
used (``*_child_node``, ``*_node_axis``) and restores it: a loaded scene
has the saved scene's tables and casts its frame bit for bit.  A JAX file
has no grouping and is collapsed anew, as the JAX package's own load
rebuilds its cluster tables.  A ``frontier`` / ``frontier_q`` scene
loads, as in JAX, with neither cluster nor wide tables: its frontier
tables are built from the loaded BVH at its first cast.

  * A file the JAX package wrote loads here: the port reads its triangle,
    BVH and level arrays and the wide layout's branching and streaming
    flags, and ignores the JAX package's lane-packed wide tables (its
    ``wide_nodes``, ``wide_leaf``, ``wide_*idx`` and ``wide_*const``).
  * A file written here has the same triangle, BVH and level keys, the
    same ``backend`` and, for a scene with wide tables, the same scalar
    ``wide_branching`` / ``wide_stream`` / ``wide_stream_nodes`` keys, but
    no lane-packed wide tables: the JAX package loads it with its cluster
    tables rebuilt and, for a ``pallas`` scene, no wide tables, so it
    casts a ``pallas`` scene on its ``jnp`` traversal; it ignores the
    grouping keys.
"""

from __future__ import annotations

import numpy as np
import torch

from ..accel.bvh import BVH
from ..core.types import DEFAULT_DEVICE, Triangles
from ..kernels.cluster import build_cluster_scene, cluster_tcap_for
from ..kernels.wide import build_wide8_scene, build_wide_scene
from .scene import RayScene

_FORMAT_VERSION = 2
_TRI_KEYS = (("tri_v0", "v0"), ("tri_e1", "edge1"), ("tri_e2", "edge2"),
             ("tri_n", "normal"), ("tri_pid", "prim_id"),
             ("tri_lay", "layers"))
_BVH_KEYS = (("bvh_min", "aabb_min"), ("bvh_max", "aabb_max"),
             ("bvh_lf", "left_first"), ("bvh_cnt", "count"),
             ("bvh_order", "tri_order"), ("bvh_axis", "split_axis"))


def save_scene(path, scene: RayScene) -> None:
    """Write ``scene`` (triangles, BVH, levels, backend) to the .npz file
    ``path``, compressed as the JAX package writes it."""
    arrs = {
        "format_version": np.int32(_FORMAT_VERSION),
        "use_bvh": np.bool_(scene.use_bvh),
        "backend": np.bytes_(scene.backend.encode()),
        "bvh_num_levels": np.int32(len(scene.bvh.levels)),
    }
    for key, field in _TRI_KEYS:
        arrs[key] = getattr(scene.tris, field).cpu().numpy()
    for key, field in _BVH_KEYS:
        arrs[key] = getattr(scene.bvh, field).cpu().numpy()
    for i, lvl in enumerate(scene.bvh.levels):
        arrs[f"bvh_level_{i}"] = lvl.cpu().numpy()
    if scene.wide is not None:
        arrs.update(wide_branching=np.int32(scene.wide.branching),
                    wide_stream=np.bool_(scene.wide.stream_leaves),
                    wide_stream_nodes=np.bool_(scene.wide.stream_nodes))
    for name, tables in (("wide", scene.wide), ("cluster", scene.cluster)):
        if getattr(tables, "child_node", None) is not None and (
                name == "cluster" or tables.branching == 8):
            arrs[f"{name}_child_node"] = tables.child_node.cpu().numpy()
            arrs[f"{name}_node_axis"] = tables.node_axis.cpu().numpy()
    np.savez_compressed(path, **arrs)


def load_scene(path, device=DEFAULT_DEVICE) -> RayScene:
    """Load a scene written by ``save_scene`` (of this package or of the
    JAX package, format v1 or v2) onto ``device``: the arrays as stored,
    the cast tables of its backend rebuilt from them."""
    with np.load(path) as z:
        version = int(z["format_version"])
        if version not in (1, 2):
            raise ValueError(f"{path}: scene format {version} is not 1 or 2")
        host_tris = {f: np.asarray(z[k]) for k, f in _TRI_KEYS}
        host = {f: np.asarray(z[k]) for k, f in _BVH_KEYS}
        levels = [np.asarray(z[f"bvh_level_{i}"])
                  for i in range(int(z["bvh_num_levels"]))]
        backend = bytes(z["backend"]).decode()
        use_bvh = bool(z["use_bvh"])
        collapsed = {name: (np.asarray(z[f"{name}_child_node"]),
                            np.asarray(z[f"{name}_node_axis"]))
                     for name in ("wide", "cluster")
                     if f"{name}_child_node" in z}
        wide_meta = None
        if "wide_branching" in z or "wide_nodes" in z:
            # the JAX package's default when a v1 file has no branching
            wide_meta = (
                int(z["wide_branching"]) if "wide_branching" in z else 2,
                bool(z["wide_stream"]) if "wide_stream" in z else False,
                bool(z["wide_stream_nodes"])
                if "wide_stream_nodes" in z else False)
    put = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    tris = Triangles(**{f: put(a) for f, a in host_tris.items()})
    bvh = BVH(**{f: put(a) for f, a in host.items()},
              levels=tuple(put(lv) for lv in levels), host=host)
    np_tris = tuple(host_tris[f] for _, f in _TRI_KEYS)
    wide = cluster = None
    if wide_meta is not None:
        branching, stream_leaves, stream_nodes = wide_meta
        kw = dict(_np=np_tris, stream_leaves=stream_leaves,
                  stream_nodes=stream_nodes, device=device)
        wide = (build_wide8_scene(bvh, tris, collapsed=collapsed.get("wide"),
                                  **kw)
                if branching == 8 else build_wide_scene(bvh, tris, **kw))
    if backend == "cluster":
        cluster = build_cluster_scene(bvh, tris, _np=np_tris,
                                      tcap=cluster_tcap_for(tris.count),
                                      device=device,
                                      collapsed=collapsed.get("cluster"))
    return RayScene(tris=tris, bvh=bvh, wide=wide, cluster=cluster,
                    use_bvh=use_bvh, backend=backend)
