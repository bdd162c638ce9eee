"""Checkpoint/resume: a stream split across two Encoder processes must be
byte-identical to the continuous encode (SURVEY §5: the encoder's
resumable state is the DPB + RC state, a plain pytree; the reference has
no checkpoint surface at all — this is a capability this build adds)."""

import pickle

import numpy as np

from svt_hevc_tpu.config import EncoderConfig
from svt_hevc_tpu.decoder.decoder import decode_stream
from svt_hevc_tpu.pipeline.encoder import Encoder

from test_inter import moving_sequence


def _collect(enc, frames):
    data = b""
    for au in enc.encode_pictures(iter(frames)):
        data += au.data
    return data


def _split_encode(cfg, frames, cut):
    """Encode frames[:cut], checkpoint through pickle (process boundary),
    restore into a FRESH Encoder, encode the rest."""
    enc1 = Encoder(cfg)
    head = _collect(enc1, frames[:cut])
    blob = pickle.dumps(enc1.checkpoint())
    enc2 = Encoder(cfg)
    enc2.restore(pickle.loads(blob))
    tail = _collect(enc2, frames[cut:])
    return head + tail


def test_resume_bit_exact_ipp():
    frames = moving_sequence(96, 64, 10, dx=2, dy=1, seed=21)
    cfg = EncoderConfig(width=96, height=64, qp=33, intra_period=-1,
                        fps_num=25, scene_change_detection=False)
    ref = _collect(Encoder(cfg), frames)
    split = _split_encode(cfg, frames, cut=5)
    assert split == ref
    # and the stream still decodes against its own recon
    decode_stream(Encoder(cfg).headers() + split)


def test_resume_bit_exact_hierarchical_vbr():
    frames = moving_sequence(96, 64, 14, dx=1, dy=2, seed=22)
    cfg = EncoderConfig(width=96, height=64, qp=34, intra_period=7,
                        fps_num=25, hierarchical_levels=2,
                        rate_control_mode=1, target_bitrate=150_000,
                        look_ahead_distance=0,
                        scene_change_detection=False)
    ref = _collect(Encoder(cfg), frames)
    split = _split_encode(cfg, frames, cut=6)
    assert split == ref


def test_resume_mid_gop_scd():
    """Cut inside a GOP with scene-change detection on: prev_y context
    must survive the checkpoint."""
    frames = moving_sequence(64, 64, 9, dx=3, dy=0, seed=23)
    cfg = EncoderConfig(width=64, height=64, qp=32, intra_period=5,
                        fps_num=30, scene_change_detection=True)
    ref = _collect(Encoder(cfg), frames)
    split = _split_encode(cfg, frames, cut=3)
    assert split == ref
