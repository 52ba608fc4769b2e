"""MossFormerGAN-SE stage-ablation profile of the port, on the card.

Counterpart of ``audiojax.utils.gan_profile``; the method of
:mod:`.zip_profile` (see there and :mod:`.ablation`): each stage is stubbed
with a shape-preserving no-op and the FULL forward re-timed.

    python -m audiojax_torch.utils.gan_profile [--seconds 6] [--dtype float32] [--json]
        [--device cpu]

Stage map, the JAX package's ten stages:

* ``stft`` / ``istft`` — the B1/B2 kernels
* ``sync_paths`` — all 12 intra/inter SyncANet paths incl. their
  unfold/refold convs and reshape plumbing (contains gau/se/fsmn below)
* ``mossformer_gau`` / ``se_layer`` / ``uni_fsmn`` / ``ffconvm`` — inner
  slices of every sync path (the GAU's two relu² attentions run on B6, its
  depthwise convs and the FSMN memory on B4)
* ``triple_attention`` — the 6 per-block 4-head (C·F)-token attentions
* ``dense_fsmn`` — the 3 dilated dense-FSMN stacks (encoder + 2 decoders)
* ``decoders`` — both decoder heads incl. sub-pixel upsample

Every stage patches the model module (``models/mossformergan_se``), whose
namespace the forward reads: the STFT kernels are bound there too.
"""
from __future__ import annotations

import dataclasses

import torch

from .zip_profile import bcast, cli, to_markdown  # noqa: F401  (to_markdown: the JAX module's name)


def build_stages(cfg):
    """Shape-correct stubs; all stages patch the MODEL module bindings."""
    import audiojax_torch.models.mossformergan_se as MG
    from .ablation import Stage

    t = cfg.fold_window // cfg.hop + 1

    return [
        Stage("stft", MG, "fast_stft_packed",
              lambda x, c: bcast(x, (x.shape[0], t, 2 * cfg.f_bins), torch.float32)),
        Stage("istft", MG, "fast_istft_packed",
              lambda s, c, out_length=None: bcast(s, (s.shape[0], cfg.fold_window),
                                                  torch.float32)),
        Stage("sync_paths", MG, "_sync_path",
              lambda p, x, c, *, axis: x),
        Stage("mossformer_gau", MG, "mossformer_gau",
              lambda p, x, c, b: x),
        Stage("triple_attention", MG, "triple_attention",
              lambda p, x, c: x),
        Stage("se_layer", MG, "se_layer", lambda p, x: x),
        Stage("uni_fsmn", MG, "_uni_fsmn", lambda p, x, lorder: x),
        Stage("ffconvm", MG, "_ffconvm_fused",
              lambda p, x, dw: bcast(x, x.shape[:-1] + (p["lin"]["w"].shape[-1],), x.dtype)),
        Stage("dense_fsmn", MG, "_dense_fsmn_block",
              lambda p, x, depth, lorder: x),
        Stage("decoders", MG, "_decoder",
              lambda p, x, c: bcast(x, (x.shape[0], x.shape[1], 2 * x.shape[2],
                                        x.shape[3]), x.dtype)),
    ]


def run(seconds: int = 6, dtype: str = "float32", iters: int = 20, *, repeats: int = 1,
        cfg=None, device=None) -> dict:
    """The report of :func:`ablation.ablate` on a ``seconds`` clip, random
    weights from seed 0 (``cfg`` replaces the default, full, config)."""
    import audiojax_torch.models.mossformergan_se as MG
    from ..device import card_line, resolve_device
    from ..runtime.registry import prepare_compute_params
    from .ablation import ablate
    from .bench_all import _clip

    dev = resolve_device(device)
    cfg = cfg or MG.MossFormerGanConfig()
    if dtype != "float32":
        cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    params = prepare_compute_params(MG.init_mossformergan(0, cfg, dev), cfg)
    n = seconds * cfg.in_sample_rate // cfg.fold_window * cfg.fold_window
    audio = torch.from_numpy(_clip((1, n), cfg.in_sample_rate)).to(dev)
    report = ablate(make_fn=lambda: MG.make_mossformergan(cfg),
                    params=params, audio=audio, sample_rate=cfg.in_sample_rate,
                    stages=build_stages(cfg), iters=iters, repeats=repeats)
    report["config"] = {"seconds": seconds, "dtype": dtype, "chip": card_line(dev)}
    return report


def main(argv=None) -> int:
    return cli(run, argv, seconds=6, prog="audiojax_torch.utils.gan_profile", doc=__doc__)


if __name__ == "__main__":
    raise SystemExit(main())
