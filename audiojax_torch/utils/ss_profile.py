"""MossFormer2-SS stage-ablation profile of the port, on the card.

Counterpart of ``audiojax.utils.ss_profile``; the method of
:mod:`.zip_profile` / :mod:`.gan_profile` (see :mod:`.ablation`): each stage
is stubbed with a shape-preserving no-op and the FULL forward re-timed at
the serving geometry.

    python -m audiojax_torch.utils.ss_profile [--seconds 2] [--dtype float32] [--json]
        [--device cpu]

Stage map, the JAX package's five stages:

* ``flash_layers`` — all 24 FLASH (GAU) attention layers (model binding;
  the group attention runs on B6)
* ``fsmn_layers`` — all 24 gated dilated-dense FSMN blocks (model binding;
  the grouped dilated memory runs on B5)
* ``dw_convs`` — every depthwise ConvModule residual inside both (B4;
  patched in ``nn.mossformer``, whose globals the two blocks read at call
  time)
* ``scale_norms`` — the FLASH ScaleNorms (same mechanism)
* ``instance_norms`` — the per-channel time InstanceNorms in the FSMN
  memory stacks (same mechanism)
"""
from __future__ import annotations

import dataclasses

import torch

from .zip_profile import cli, to_markdown  # noqa: F401  (to_markdown: the JAX module's name)


def build_stages(cfg):
    import audiojax_torch.models.mossformer2_ss as SS
    import audiojax_torch.nn.mossformer as NM
    from .ablation import Stage

    return [
        Stage("flash_layers", SS, "flash_layer", lambda p, x, **k: x),
        Stage("fsmn_layers", SS, "gated_fsmn_block_dilated", lambda p, x, **k: x),
        # inner slices: flash_layer/gated_fsmn_block_dilated read these from
        # nn.mossformer's module globals at call time, so patching the
        # DEFINING module reaches inside the (by-value-bound) blocks; the
        # port's _depthwise_res takes no pad (it derives it from the kernel)
        Stage("dw_convs", NM, "_depthwise_res", lambda p, x: x),
        Stage("scale_norms", NM, "scale_norm",
              lambda p, x, *, eps=1e-5: x * p["g"]),
        Stage("instance_norms", NM, "instance_norm_t",
              lambda p, x, eps=1e-5: x),
    ]


def run(seconds: int = 2, dtype: str = "float32", iters: int = 20, *, repeats: int = 1,
        cfg=None, device=None) -> dict:
    """The report of :func:`ablation.ablate` on a ``seconds`` clip, random
    weights from seed 0 (``cfg`` replaces the default, full, config)."""
    import audiojax_torch.models.mossformer2_ss as SS
    from ..device import card_line, resolve_device
    from ..runtime.registry import prepare_compute_params
    from .ablation import ablate
    from .bench_all import _clip

    dev = resolve_device(device)
    cfg = cfg or SS.MossFormer2SsConfig()
    if dtype != "float32":
        cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    params = prepare_compute_params(SS.init_mossformer2_ss(0, cfg, dev), cfg)
    audio = torch.from_numpy(_clip((1, seconds * cfg.in_sample_rate), cfg.in_sample_rate)).to(dev)
    report = ablate(make_fn=lambda: SS.make_mossformer2_ss(cfg),
                    params=params, audio=audio, sample_rate=cfg.in_sample_rate,
                    stages=build_stages(cfg), iters=iters, repeats=repeats)
    report["config"] = {"seconds": seconds, "dtype": dtype, "chip": card_line(dev)}
    return report


def main(argv=None) -> int:
    return cli(run, argv, seconds=2, prog="audiojax_torch.utils.ss_profile", doc=__doc__)


if __name__ == "__main__":
    raise SystemExit(main())
