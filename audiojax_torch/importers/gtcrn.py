"""GTCRN checkpoint importer: upstream gtcrn-main state dict → parameter tree.

Counterpart of ``audiojax.importers.gtcrn.import_gtcrn``; it returns numpy
(the JAX package wraps the same tree in ``jnp`` arrays).  BatchNorms are
fused into their convs here, at import.  Key map (upstream names):

  encoder.en_convs.{0,1}   ConvBlock    conv+bn+act(PReLU)
  encoder.en_convs.{2,3,4} GTConvBlock  point_conv1/point_bn1/point_act,
                                        depth_conv/depth_bn/depth_act,
                                        point_conv2/point_bn2, tra.att_gru/att_fc
  dpgrnn{1,2}              GRNN pairs (rnn1, rnn2 ± _reverse), fc, ln
  decoder.de_convs.{0..4}  mirrored with ConvTranspose2d modules
  erb.{erb_fc,ierb_fc}     the frozen ERB bank, checked against the formula

``import_h_gtcrn`` reads H-GTCRN's GTCRN-IVA checkpoint: the same blocks,
with each GT block's conv/bn/act nested under ``point_conv1``,
``depth_conv`` and ``point_conv2``, regular (not transposed) convs in the
decoder's GT blocks, an 18-channel first encoder conv and the ERB bank at
scale 24.7.
"""
from __future__ import annotations

import numpy as np

from ..nn.erb import erb_filters
from .common import (
    fuse_bn_conv2d,
    fuse_bn_deconv2d,
    gru_params,
    linear,
    to_np,
    unwrap_state_dict,
)

__all__ = ["import_gtcrn", "import_h_gtcrn"]


def _conv_block(sd, key, groups=1, deconv=False, last=False):
    fuse = fuse_bn_deconv2d if deconv else fuse_bn_conv2d
    p = {"conv": fuse(sd, f"{key}.conv", f"{key}.bn", groups=groups)}
    if not last:
        p["alpha"] = to_np(sd[f"{key}.act.weight"]).astype(np.float32)
    return p


def _tra(sd, key):
    return {"gru": gru_params(sd, f"{key}.att_gru"), "fc": linear(sd, f"{key}.att_fc")}


def _gt_block(sd, key, deconv=False):
    fuse = fuse_bn_deconv2d if deconv else fuse_bn_conv2d
    pc1 = fuse(sd, f"{key}.point_conv1", f"{key}.point_bn1")
    pc1["alpha"] = to_np(sd[f"{key}.point_act.weight"]).astype(np.float32)
    hidden = pc1["w"].shape[-1]
    return {
        "pc1": pc1,
        "depth": fuse(sd, f"{key}.depth_conv", f"{key}.depth_bn", groups=hidden),
        "depth_a": {"alpha": to_np(sd[f"{key}.depth_act.weight"]).astype(np.float32)},
        "pc2": fuse(sd, f"{key}.point_conv2", f"{key}.point_bn2"),
        "tra": _tra(sd, f"{key}.tra"),
    }


def _stack_grus(sd, base, suffix=""):
    g1 = gru_params(sd, f"{base}.rnn1", suffix)
    g2 = gru_params(sd, f"{base}.rnn2", suffix)
    return {k: np.stack([g1[k], g2[k]]) for k in g1}


def _ln(sd, key):
    return {"g": to_np(sd[f"{key}.weight"]).astype(np.float32),
            "b": to_np(sd[f"{key}.bias"]).astype(np.float32)}


def _dpgrnn(sd, key):
    return {
        "intra_fwd": _stack_grus(sd, f"{key}.intra_rnn"),
        "intra_bwd": _stack_grus(sd, f"{key}.intra_rnn", "_reverse"),
        "intra_fc": linear(sd, f"{key}.intra_fc"),
        "intra_ln": _ln(sd, f"{key}.intra_ln"),
        "inter": _stack_grus(sd, f"{key}.inter_rnn"),
        "inter_fc": linear(sd, f"{key}.inter_fc"),
        "inter_ln": _ln(sd, f"{key}.inter_ln"),
    }


def _consume_erb(sd, n_low: int, n_erb: int, n_fft: int = 512, scale: float = 21.4):
    """Read and verify the checkpoint's ERB filter bank (fail-closed).

    Upstream checkpoints carry the analytic triangular bank as frozen
    parameters (``erb.erb_fc.weight`` and its transpose ``erb.ierb_fc.weight``);
    the model bakes the same bank in as a constant (``nn/erb.py``), so a
    checkpoint whose bank differs from the formula is refused."""
    for key, transpose in (("erb.erb_fc.weight", False), ("erb.ierb_fc.weight", True)):
        if key not in sd:
            continue
        got = to_np(sd[key])
        want = erb_filters(n_low, n_erb, n_fft, scale=scale).astype(np.float64)
        if transpose:
            want = want.T
        if got.shape != want.shape or not np.allclose(got, want, atol=1e-5):
            raise ValueError(
                f"checkpoint {key} {got.shape} does not match the analytic "
                f"ERB bank {want.shape} the model bakes in (n_low={n_low}, "
                f"n_erb={n_erb}); refusing to import"
            )


def _gt_block_nested(sd, key):
    """H-GTCRN GT block: conv/bn/act nested one level deeper."""
    pc1 = fuse_bn_conv2d(sd, f"{key}.point_conv1.conv", f"{key}.point_conv1.bn")
    pc1["alpha"] = to_np(sd[f"{key}.point_conv1.act.weight"]).astype(np.float32)
    hidden = pc1["w"].shape[-1]
    return {
        "pc1": pc1,
        "depth": fuse_bn_conv2d(sd, f"{key}.depth_conv.conv", f"{key}.depth_conv.bn",
                                groups=hidden),
        "depth_a": {"alpha": to_np(sd[f"{key}.depth_conv.act.weight"]).astype(np.float32)},
        "pc2": fuse_bn_conv2d(sd, f"{key}.point_conv2.conv", f"{key}.point_conv2.bn"),
        "tra": _tra(sd, f"{key}.tra"),
    }


def _outer_blocks(sd) -> dict:
    """The ConvBlocks and dual-path blocks GTCRN and H-GTCRN share."""
    return {
        "enc0": _conv_block(sd, "encoder.en_convs.0"),
        "enc1": _conv_block(sd, "encoder.en_convs.1", groups=2),
        "dp1": _dpgrnn(sd, "dpgrnn1"),
        "dp2": _dpgrnn(sd, "dpgrnn2"),
        "dec1": _conv_block(sd, "decoder.de_convs.3", groups=2, deconv=True),
        "dec0": _conv_block(sd, "decoder.de_convs.4", deconv=True, last=True),
    }


def import_gtcrn(ckpt):
    """Upstream GTCRN checkpoint (state dict or wrapped) → numpy tree."""
    sd = unwrap_state_dict(ckpt)
    _consume_erb(sd, 65, 64)
    params = _outer_blocks(sd)
    for i, src in enumerate((2, 3, 4)):
        params[f"enc_gt{i}"] = _gt_block(sd, f"encoder.en_convs.{src}")
    for i in range(3):
        params[f"dec_gt{i}"] = _gt_block(sd, f"decoder.de_convs.{i}", deconv=True)
    return params


def import_h_gtcrn(ckpt):
    """Upstream H-GTCRN (GTCRN-IVA) checkpoint → numpy tree."""
    sd = unwrap_state_dict(ckpt)
    _consume_erb(sd, 65, 64, scale=24.7)
    params = _outer_blocks(sd)
    for i, src in enumerate((2, 3, 4)):
        params[f"enc_gt{i}"] = _gt_block_nested(sd, f"encoder.en_convs.{src}")
    for i in range(3):
        params[f"dec_gt{i}"] = _gt_block_nested(sd, f"decoder.de_convs.{i}")
    return params
