"""ZipEnhancer stage-ablation profile of the port, on the card.

Counterpart of ``audiojax.utils.zip_profile``: each stage of the forward is
stubbed with a shape-preserving no-op (``utils/ablation.py``) and the FULL
forward re-timed; the latency recovered is the stage's in-context cost.

    python -m audiojax_torch.utils.zip_profile [--seconds 6] [--dtype float32] [--json]
        [--device cpu]

Stage map, the JAX package's, stage for stage:

* ``stft`` / ``istft`` — the B1/B2 kernels
* ``dense_encoder`` / ``decoder_pair`` — the causal DenseBlockV2 stacks
* ``zipformer_layers`` — all 8 dual-path Zipformer2 layers (4 encoders × 2)
* ``dualpath_plumbing`` — the two plain dual-path encoders incl. their
  transpose/reshape plumbing (layers alone are covered above)
* inner slices of every layer: ``attention_weights`` (shared QK+pos scores,
  B3), ``self_attention`` (sa1+sa2), ``nonlin_attention``, ``conv_module``
  (conv1+conv2 gated depthwise, B4), ``feed_forward`` (ff1-3)

The port's forward binds its kernels and blocks by value at import, so each
stage patches the namespace the forward reads: ``stft``/``istft``,
``dense_encoder``, ``decoder_pair``, ``zipformer_layers`` and
``dualpath_plumbing`` the model module (``models/zipenhancer``), the inner
slices ``nn/zipformer``, whose ``zipformer_layer`` reads them at call time.
Stubs broadcast a mean of their input, so that upstream work keeps a data
dependency, as in the JAX package; the encoder's and decoders' output
shapes come from one recorded pass (``ablation.output_specs``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch


def bcast(x: torch.Tensor, shape, dtype) -> torch.Tensor:
    """The mean of ``x`` broadcast to ``shape`` in ``dtype``, materialized."""
    return x.mean().to(dtype).expand(shape).contiguous()


def build_stages(cfg, params, audio):
    """Shape-correct stubs; the encoder's and decoders' shapes from one pass."""
    import audiojax_torch.models.zipenhancer as ZM
    import audiojax_torch.nn.zipformer as ZF
    from .ablation import Stage, output_specs

    t = cfg.fold_window // cfg.hop + 1
    f = cfg.f_bins
    specs = output_specs(lambda: ZM.make_zipenhancer(cfg)(params, audio), ZM,
                         ("dense_encoder", "decoder_pair"))
    enc_sh, dec_sh = specs["dense_encoder"], specs["decoder_pair"]

    return [
        Stage("stft", ZM, "fast_stft_packed",
              lambda x, c: bcast(x, (x.shape[0], t, 2 * f), torch.float32)),
        Stage("istft", ZM, "fast_istft_packed",
              lambda s, c, out_length=None: bcast(s, (s.shape[0], cfg.fold_window),
                                                  torch.float32)),
        Stage("dense_encoder", ZM, "dense_encoder",
              lambda p, x, c: bcast(x, *enc_sh)),
        Stage("decoder_pair", ZM, "decoder_pair",
              lambda p, x, c: (bcast(x, *dec_sh[0]), bcast(x, *dec_sh[1]))),
        Stage("zipformer_layers", ZM, "zipformer_layer",
              lambda p, x, pos, **k: x),
        Stage("dualpath_plumbing", ZM, "dualpath_encoder",
              lambda p, x, c: x),
        Stage("attention_weights", ZF, "attention_weights",
              lambda p, x, pos, *, num_heads, query_head_dim, pos_head_dim:
              bcast(x, (x.shape[0], num_heads, x.shape[1], x.shape[1]), x.dtype)),
        Stage("self_attention", ZF, "self_attention",
              lambda p, x, attn, *, num_heads: x * attn.mean().to(x.dtype)),
        Stage("nonlin_attention", ZF, "nonlin_attention",
              lambda p, x, attn0: x * attn0.mean().to(x.dtype)),
        Stage("conv_module", ZF, "conv_module", lambda p, x: x),
        Stage("feed_forward", ZF, "_feed_forward", lambda p, x, act=None: x),
    ]


def run(seconds: int = 6, dtype: str = "float32", iters: int = 20, *, repeats: int = 1,
        cfg=None, device=None) -> dict:
    """The report of :func:`ablation.ablate` on a ``seconds`` clip, random
    weights from seed 0, with ``config`` (``chip``: the card line).  ``cfg``
    replaces the default (full) config."""
    import audiojax_torch.models.zipenhancer as ZM
    from ..device import card_line, resolve_device
    from ..runtime.registry import prepare_compute_params
    from .ablation import ablate
    from .bench_all import _clip

    dev = resolve_device(device)
    cfg = cfg or ZM.ZipEnhancerConfig()
    if dtype != "float32":
        cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    params = prepare_compute_params(ZM.init_zipenhancer(0, cfg, dev), cfg)
    n = seconds * cfg.in_sample_rate // cfg.fold_window * cfg.fold_window
    audio = torch.from_numpy(_clip((1, n), cfg.in_sample_rate)).to(dev)
    report = ablate(make_fn=lambda: ZM.make_zipenhancer(cfg),
                    params=params, audio=audio, sample_rate=cfg.in_sample_rate,
                    stages=build_stages(cfg, params, audio), iters=iters, repeats=repeats)
    report["config"] = {"seconds": seconds, "dtype": dtype, "chip": card_line(dev)}
    return report


def to_markdown(report: dict) -> str:
    base = report["baseline"]
    spread = (f", loops spread {base['spread_s'] * 1e3:.2f} ms" if "spread_s" in base else "")
    lines = [
        f"Baseline: RTF {base['rtf']:.6f} ({base['latency_s'] * 1e3:.2f} ms{spread}, "
        f"{report['config']['seconds']} s clip, {report['config']['dtype']}, "
        f"{report['config']['chip']})",
        "",
        "| stage | attributed ms | % of forward | RTF without it |",
        "|---|---|---|---|",
    ]
    for r in sorted(report["stages"], key=lambda r: -r["attributed_s"]):
        lines.append(f"| {r['name']} | {r['attributed_s'] * 1e3:.2f} | "
                     f"{r['attributed_pct']:.1f}% | {r['rtf']:.6f} |")
    return "\n".join(lines)


def cli(run_fn, argv, *, seconds: int, prog: str, doc: str) -> int:
    """The profiles' shared command line (the JAX package's flags, and
    ``--repeats`` and ``--device``)."""
    ap = argparse.ArgumentParser(prog=prog, description=doc,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seconds", type=int, default=seconds)
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=1,
                    help="timed loops a measurement, the fastest kept (spread reported)")
    ap.add_argument("--json", action="store_true", help="JSON instead of markdown")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    report = run_fn(seconds=args.seconds, dtype=args.dtype, iters=args.iters,
                    repeats=args.repeats, device=args.device)
    print(json.dumps(report) if args.json else to_markdown(report))
    return 0


def main(argv=None) -> int:
    return cli(run, argv, seconds=6, prog="audiojax_torch.utils.zip_profile", doc=__doc__)


if __name__ == "__main__":
    raise SystemExit(main())
