"""Multi-chip sharding of the encoder frontend (SURVEY.md §2.6 mapping).

The reference scales with pthreads over shared memory: picture-level
pipelining, ME segment grids, EncDec wavefronts, per-tile CABAC
(EbSystemResourceManager.c FIFOs; EbEncHandle.c:1726 thread budgeting).
The equivalents here are device-mesh axes instead of thread
pools:

  gop axis  — data parallelism over in-flight pictures (the analogue of
              many pictures in flight across process threads);
  tile axis — spatial parallelism over picture rows (the analogue of ME
              segments / EncDec segment rows), with explicit halo
              exchange of boundary rows between devices via lax.ppermute where
              a search window crosses the shard boundary.

Everything compiles under one jit: XLA inserts the collectives for the
gop-sharded batch; the tile-sharded motion search uses shard_map so the
halo exchange is explicit and minimal (2 x halo rows per neighbor pair
per step, device to device, never round trips through the host).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:
    from jax import shard_map            # jax >= 0.4.35 style
except ImportError:                      # pragma: no cover
    from jax.experimental.shard_map import shard_map

from ..tpu.analysis import analyze_frame
from ..tpu.me import hme_search

# full-res halo rows needed by the 3-level HME (reach ~44 rows at the
# default n=16, r=4; see tpu.me.hme_search) rounded up to one 64-row slab
HALO = 64


def make_mesh(n_devices: int | None = None, gop: int | None = None) -> Mesh:
    """Factor the devices into a (gop, tile) mesh. gop defaults to 2 when
    even (pictures in flight), the rest becomes spatial tile shards."""
    devs = jax.devices()
    n = n_devices or len(devs)
    if gop is None:
        gop = 2 if n % 2 == 0 and n > 1 else 1
    tile = n // gop
    return Mesh(np.asarray(devs[:gop * tile]).reshape(gop, tile),
                ("gop", "tile"))


def _exchange_halo(x: jnp.ndarray, h: int, axis: str, n_shards: int):
    """(top, bottom) halo slabs of the up/down neighbors of this shard's
    rows, exchanged over the mesh axis with lax.ppermute; picture-edge
    shards replicate their own boundary row (the sharded analogue of the
    edge padding in tpu.me's search kernels)."""
    idx = jax.lax.axis_index(axis)
    down = [(i, i + 1) for i in range(n_shards - 1)]   # send to next shard
    up = [(i + 1, i) for i in range(n_shards - 1)]     # send to previous
    from_above = jax.lax.ppermute(x[-h:], axis, down)
    from_below = jax.lax.ppermute(x[:h], axis, up)
    top = jnp.where(idx == 0, jnp.broadcast_to(x[:1], (h,) + x.shape[1:]),
                    from_above)
    bot = jnp.where(idx == n_shards - 1,
                    jnp.broadcast_to(x[-1:], (h,) + x.shape[1:]), from_below)
    return top, bot


def sharded_hme(src: jnp.ndarray, ref: jnp.ndarray, mesh: Mesh,
                n: int = 16, r: int = 4):
    """Row-sharded hierarchical ME: each tile shard searches its own rows
    against a halo-extended reference slab (reference analogue: the 6x10
    ME segment grid, EbEncHandle.c:1680, re-cut as mesh rows).

    src/ref: (H, W) with H a multiple of 64 * tile-shards. Returns
    (mv_q, sad) like tpu.me.hme_search, sharded over rows. Block MVs whose
    search reach crosses the PICTURE edge may differ from the single-chip
    field in the outermost block rows (the halo replicates full-res edge
    rows, the global kernel edge-pads decimated planes); both are valid
    ME seeds.
    """
    nt = mesh.shape["tile"]

    def body(s_loc, r_loc):
        st, sb = _exchange_halo(s_loc, HALO, "tile", nt)
        rt, rb = _exchange_halo(r_loc, HALO, "tile", nt)
        s_ext = jnp.concatenate([st, s_loc, sb], axis=0)
        r_ext = jnp.concatenate([rt, r_loc, rb], axis=0)
        mv, sad = hme_search(s_ext, r_ext, n, r)
        k = HALO // n
        nb = s_loc.shape[0] // n
        return mv[k:k + nb], sad[k:k + nb]

    fn = shard_map(body, mesh=mesh, in_specs=(P("tile", None),) * 2,
                   out_specs=(P("tile", None, None), P("tile", None)))
    return fn(src.astype(jnp.float32), ref.astype(jnp.float32))


def frontend_step(mesh: Mesh):
    """Build the jitted multi-chip frontend step: per-picture analysis
    (intra search + variance + decimation) batched over the gop axis, rows
    sharded over the tile axis (XLA inserts any cross-row collectives),
    plus a global rate-proxy psum. Returns fn(batch) -> (analysis, total).
    """
    in_sh = NamedSharding(mesh, P("gop", "tile", None))

    def step(frames_batch):
        out = jax.vmap(analyze_frame)(frames_batch)
        total = sum(jnp.sum(out[f"cost{k}"]) for k in (4, 8, 16, 32))
        return out, total

    return jax.jit(step, in_shardings=in_sh), in_sh


def gop_encode_step(mesh: Mesh):
    """Build the jitted multi-chip ENCODE step: the full fused P-picture
    device pipeline (HME + dense MD + OIS + quadtree decision + normative
    encode pass, tpu.encode.fast_p_fused_packed) data-parallel over
    independent pictures, sharded across every device of the mesh (gop and
    tile axes flattened onto the batch). This is the encode itself on the
    mesh — mini-GOPs / P chains with disjoint references are independent
    work items (SURVEY.md §2.6 "data parallelism over pictures"; the
    reference keeps dozens of pictures in flight, EbEncHandle.c:1645).

    Returns (fn, in_sharding): fn(src3, ref3, hme_mv, qp, qp_c) -> packed
    per-picture buffers (tpu.encode.fused_specs layout), where src3/ref3
    are (B, H, W) luma + (B, H/2, W/2) cb/cr stacks and B divides the
    device count."""
    from ..tpu.encode import fast_p_fused_packed

    batch_sh = NamedSharding(mesh, P(("gop", "tile"),))

    def one(sy, scb, scr, ry, rcb, rcr, mv, qp, qp_c):
        return fast_p_fused_packed(sy, scb, scr, ry, rcb, rcr, mv, qp,
                                   qp_c, ctb_log2=5,
                                   w=sy.shape[1], h=sy.shape[0],
                                   bit_depth=8)

    def step(src3, ref3, hme_mv, qp, qp_c):
        return jax.vmap(
            lambda sy, scb, scr, ry, rcb, rcr, mv: one(
                sy, scb, scr, ry, rcb, rcr, mv, qp, qp_c)
        )(src3[0], src3[1], src3[2], ref3[0], ref3[1], ref3[2], hme_mv)

    in_sh = (
        (batch_sh, batch_sh, batch_sh),
        (batch_sh, batch_sh, batch_sh),
        batch_sh, None, None,
    )
    return jax.jit(step, in_shardings=in_sh), batch_sh
