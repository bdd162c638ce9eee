"""Encoder-integrated picture-level parallelism over the device mesh.

The reference's scaling identity is MANY PICTURES IN FLIGHT: dozens of
pictures move through its 13-process pipeline concurrently, bounded only
by reference dependencies (EbEncHandle.c:1645-1671 picture pools;
EbSystemResourceManager.c FIFOs). The equivalent implemented
here: within a hierarchical low-delay GOP, every NON-REFERENCE leaf
picture (temporal layer == hierarchical_levels) depends only on
already-coded lower-layer pictures — so a group of consecutive leaves is
embarrassingly parallel. They are dispatched as ONE vmapped
fast_p_fused_dev graph whose batch axis is sharded over ALL devices of
the mesh (jax.sharding.NamedSharding over a flat "pics" axis): each chip
encodes one picture's full device pipeline (HME + dense MD + decision +
encode pass + DLF/SAO), XLA/ICI handle distribution, and the host then
walks each lane's maps for CABAC exactly as in the single-device path.

The batched lanes compute the SAME graph as the per-picture path, so the
emitted stream is byte-identical to single-device encoding
(tests/test_mesh_encoder.py asserts equality) — picture parallelism is a
scheduling choice, never a quality/bitstream change. Enabled by
EncoderConfig.mesh_pictures when >1 JAX device is visible.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def _batched_graphs(ctb_log2: int, w: int, h: int, bit_depth: int,
                    dlf: bool, sao: bool, min_intra_log2: int,
                    subpel_min: int, n_dev: int):
    """(batched_hme, batched_fast_p) jitted over a flat "pics" mesh axis
    covering n_dev devices. Compiled once per static configuration."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ..tpu.encode import fast_p_fused_dev
    from ..tpu.me import hme_search

    mesh = Mesh(np.asarray(jax.devices()[:n_dev]), ("pics",))
    sh = NamedSharding(mesh, P("pics"))

    def one(sy, scb, scr, ry, rcb, rcr, mv, qp, qp_c, lam,
            col_mv, col_valid, tb, td):
        return fast_p_fused_dev(
            sy, scb, scr, ry, rcb, rcr, mv, qp, qp_c, lam,
            col_mv, col_valid, tb, td,
            ctb_log2=ctb_log2, w=w, h=h, bit_depth=bit_depth,
            dlf=dlf, sao=sao, min_intra_log2=min_intra_log2,
            subpel_min=subpel_min)

    bf = jax.jit(jax.vmap(one), in_shardings=sh)
    bh = jax.jit(jax.vmap(lambda s, r: hme_search(s, r)[0]),
                 in_shardings=sh)
    return bh, bf, jnp


def dispatch_leaf_batch(enc, feat, items):
    """Dispatch a group of independent leaf pictures through the
    mesh-sharded batched graph.

    enc: the Encoder (device DPB / motion caches). items: list of dicts
    {frame, poc, qp, ref (planes, poc), col_poc}. Returns a list of
    `precomputed` tuples consumable by Encoder.encode_frame(...,
    precomputed=...), one per item, in order."""
    import jax.numpy as jnp_  # noqa: F401  (ensure jax is importable)

    from ..core.ctu import chroma_qp
    from ..core.rdo import lambda_sse
    from ..tpu import encode as tenc

    cfg = enc.cfg
    cw, ch = cfg.coded_width, cfg.coded_height
    w64, h64 = (cw + 63) // 64 * 64, (ch + 63) // 64 * 64
    import jax
    n_dev = len(jax.devices())
    # pad the batch to the device count so the "pics" axis shards evenly
    # (sharded axes must divide; padded lanes replicate the last picture
    # and are discarded after the dispatch)
    n_real = len(items)
    items = list(items) + [items[-1]] * (-n_real % n_dev)
    bh, bf, jnp = _batched_graphs(
        cfg.ctb_log2, cw, ch, cfg.bit_depth,
        cfg.enable_deblocking, cfg.enable_sao,
        feat.p_min_intra_log2, feat.subpel_min_size, n_dev)

    def pad3(planes):
        return tenc.prep_planes(
            np.ascontiguousarray(np.asarray(planes[0])),
            np.ascontiguousarray(np.asarray(planes[1])),
            np.ascontiguousarray(np.asarray(planes[2])), w64, h64)

    # host-stacked batch inputs (one upload each)
    srcs = [pad3((it["frame"].y, it["frame"].cb, it["frame"].cr))
            for it in items]
    refs = [pad3(it["ref"][0]) for it in items]
    sy = jnp.stack([s[0] for s in srcs])
    scb = jnp.stack([s[1] for s in srcs])
    scr = jnp.stack([s[2] for s in srcs])
    ry = jnp.stack([r[0] for r in refs])
    rcb = jnp.stack([r[1] for r in refs])
    rcr = jnp.stack([r[2] for r in refs])

    mv = bh(sy, ry)

    zmv = np.zeros((h64 // 16, w64 // 16, 2), np.int32)
    zval = np.zeros((h64 // 16, w64 // 16), bool)
    col_mv, col_val, tbs, tds = [], [], [], []
    for it in items:
        ent = (enc._dev_motion.get((it["col_poc"], w64, h64))
               if it["col_poc"] is not None else None)
        if ent is None:
            col_mv.append(zmv); col_val.append(zval)
            tbs.append(1); tds.append(1)
        else:
            col_mv.append(np.asarray(ent[0]))
            col_val.append(np.asarray(ent[1]))
            tb = it["poc"] - it["ref"][1]
            tbs.append(tb)
            tds.append(it["col_poc"] - ent[2]
                       if ent[2] is not None else tb)
    qp_v = jnp.asarray([it["qp"] for it in items], jnp.int32)
    qpc_v = jnp.asarray([chroma_qp(it["qp"], 0, cfg.chroma_format)
                         for it in items], jnp.int32)
    lam_v = jnp.asarray([lambda_sse(it["qp"]) for it in items],
                        jnp.float32)
    out = bf(sy, scb, scr, ry, rcb, rcr, mv, qp_v, qpc_v, lam_v,
             jnp.stack([jnp.asarray(c) for c in col_mv]),
             jnp.stack([jnp.asarray(c) for c in col_val]),
             jnp.asarray(tbs, jnp.int32), jnp.asarray(tds, jnp.int32))
    (packed, rec_y, rec_cb, rec_cr, out_mv, out_valid, lv_dev) = out
    res = []
    for b in range(n_real):
        lv_b = jax.tree.map(lambda a: a[b], lv_dev)
        res.append((packed[b], (rec_y[b], rec_cb[b], rec_cr[b]),
                    (out_mv[b], out_valid[b]), lv_b))
    return res
