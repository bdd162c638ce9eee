"""svt_hevc_tpu — an HEVC (H.265) encoder built from scratch in JAX.

A JAX/XLA re-design of the capabilities of SVT-HEVC
(reference: OpenVisualCloud/SVT-HEVC). The pixel-parallel compute path
(analysis, intra/inter prediction, transforms, quantization, in-loop
filters, distortion metrics) runs as batched jitted JAX programs on the
accelerator (an NVIDIA GPU; the CPU backend runs the same graphs for
tests); the irreducibly sequential entropy layer (CABAC bin coding) runs
on the host (Python reference backend + native C backend), tile-parallel,
exactly mirroring the reference's per-tile entropy design
(reference: Source/Lib/Codec/EbEntropyCodingProcess.c:313).

Public API (analogue of Source/API/EbApi.h):
    from svt_hevc_tpu import Encoder, EncoderConfig
    enc = Encoder(EncoderConfig(width=..., height=..., qp=32))
    stream: bytes = enc.encode(frames)         # Annex-B byte stream

Streaming API (EbH265EncSendPicture / EbH265GetPacket analogue):
    from svt_hevc_tpu import EncoderHandle
    h = EncoderHandle(cfg); h.send_picture(f); ...; h.send_eos()
    for pkt in h.packets(): out.write(pkt.data)
"""

import os as _os

import jax as _jax

# Persistent XLA compilation cache: the fused encode graphs take minutes
# to compile and milliseconds to reload. JAX reads JAX_COMPILATION_CACHE_DIR
# itself; without it the cache lives at a fixed path inside the checkout,
# so a later run finds what an earlier one stored.
if "JAX_COMPILATION_CACHE_DIR" not in _os.environ:
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))), ".jax_cache"))

from .api import EncoderHandle, Packet
from .config import EncoderConfig
from .pipeline.encoder import Encoder

__version__ = "0.1.0"

__all__ = ["Encoder", "EncoderConfig", "EncoderHandle", "Packet",
           "__version__"]
