"""Assigned input shapes and the functions that make concrete batches.

Port of the concrete half of ``repro/configs/shapes.py``: the four shapes
per architecture, which cells run, and the functions that make real
batches for smoke runs and the embeds / enc-dec branch of
``launch/train.py``.  The data are drawn from numpy's ``default_rng(0)``
exactly as the reference's ``_arr`` draws them (every call starts a new
generator, so ``tgt_tokens`` and ``targets`` of one batch are the same
draw), so both packages build the same arrays.  The abstract half
(``ShapeDtypeStruct`` specs and ``input_specs``) belongs with the dry-run
tooling.

Four shapes per architecture (40 cells):
  train_4k     seq 4096  x global_batch 256   -> train_step
  prefill_32k  seq 32768 x global_batch 32    -> prefill_step
  decode_32k   seq 32768 x global_batch 128   -> decode_step (1 new token)
  long_500k    seq 524288 x global_batch 1    -> decode_step; requires
               sub-quadratic attention => runs only for SSM/hybrid archs
               (mamba2-2.7b, jamba-v0.1-52b); skipped for the 8 pure
               full-attention archs (incl. MLA: compressed cache, still
               quadratic attention).

Enc-dec (seamless): train/prefill split seq into src|tgt halves; decode
cells use a 4096-frame encoder memory beside the seq_len self-attn cache.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.layers import dtype_of
from ..models.model import Model

CROSS_SEQ_DECODE = 4096


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def is_subquadratic(cfg: ModelConfig) -> bool:
    return any(s.mixer == "mamba" for s in cfg.layer_pattern)


def cell_status(cfg: ModelConfig, shape: ShapeSpec) -> str:
    """'run' or a skip reason."""
    if shape.name == "long_500k" and not is_subquadratic(cfg):
        return "skip: full quadratic attention at 524288 ctx (per assignment)"
    return "run"


def _arr(shape, dtype: torch.dtype, device, fill: str = "zeros",
         vocab: int | None = None) -> torch.Tensor:
    if fill == "tokens":
        rng = np.random.default_rng(0)
        return torch.as_tensor(rng.integers(0, vocab, shape)).to(
            device=device, dtype=dtype)
    if fill == "normal":
        rng = np.random.default_rng(0)
        return torch.as_tensor(rng.standard_normal(shape) * 0.02).to(
            device=device, dtype=dtype)
    if fill == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if fill == "arange3":  # mrope positions: three equal streams
        _, _, s = shape
        return torch.arange(s, dtype=dtype, device=device)[None, None, :] \
            .expand(shape)
    return torch.zeros(shape, dtype=dtype, device=device)


def train_batch_specs(cfg: ModelConfig, batch: int, seq: int,
                      device=None) -> dict:
    """A concrete training batch of the config's input mode, on ``device``
    (the CPU when None, as ``data.pipeline.batch_from_grains``)."""
    i32, f32 = torch.int32, torch.float32
    emb_dt = dtype_of(cfg.compute_dtype)
    v = cfg.vocab_size
    if cfg.is_enc_dec:
        src, tgt = seq // 2, seq // 2
        return {
            "src_embeds": _arr((batch, src, cfg.d_model), emb_dt, device,
                               "normal"),
            "tgt_tokens": _arr((batch, tgt), i32, device, "tokens", v),
            "targets": _arr((batch, tgt), i32, device, "tokens", v),
            "loss_mask": _arr((batch, tgt), f32, device, "ones"),
        }
    if cfg.input_mode == "embeds":
        pos_shape = (batch, 3, seq) if cfg.mrope_sections else (batch, seq)
        return {
            "embeds": _arr((batch, seq, cfg.d_model), emb_dt, device,
                           "normal"),
            "positions": _arr(pos_shape, i32, device,
                              "arange3" if cfg.mrope_sections else "zeros"),
            "targets": _arr((batch, seq), i32, device, "tokens", v),
            "loss_mask": _arr((batch, seq), f32, device, "ones"),
        }
    return {
        "tokens": _arr((batch, seq), i32, device, "tokens", v),
        "targets": _arr((batch, seq), i32, device, "tokens", v),
        "loss_mask": _arr((batch, seq), f32, device, "ones"),
    }


def prefill_batch_specs(cfg: ModelConfig, batch: int, seq: int,
                        device=None) -> dict:
    b = train_batch_specs(cfg, batch, seq, device)
    b.pop("targets", None)
    b.pop("loss_mask", None)
    return b


def decode_input_specs(cfg: ModelConfig, batch: int, seq: int, device=None):
    """Returns (inputs, caches, pos) for decode_step: zeroed caches of
    ``seq`` positions (enc-dec: ``CROSS_SEQ_DECODE`` memory positions) and
    ``pos = seq - 1``."""
    i32 = torch.int32
    emb_dt = dtype_of(cfg.compute_dtype)
    model = Model(cfg, device=device)
    cross = CROSS_SEQ_DECODE if cfg.is_enc_dec else None
    caches = model.init_cache(batch, seq, cross_seq=cross)
    if cfg.input_mode == "embeds" and not cfg.is_enc_dec:
        pos_shape = (batch, 3, 1) if cfg.mrope_sections else (batch, 1)
        inputs = {
            "embeds": _arr((batch, 1, cfg.d_model), emb_dt, model.device,
                           "normal"),
            "positions": _arr(pos_shape, i32, model.device, "zeros"),
        }
    else:
        inputs = _arr((batch, 1), i32, model.device, "tokens", cfg.vocab_size)
    pos = torch.tensor(seq - 1, dtype=i32, device=model.device)
    return inputs, caches, pos
