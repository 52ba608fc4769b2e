"""Regenerate the port's README performance tables from ``bench_all`` rows.

Counterpart of ``audiojax.utils.readme_tables``: the same pure functions
over the same row dicts, and a ``main`` that rewrites marker-delimited
regions of README.md, here only the port's own::

    python -m audiojax_torch.utils.bench_all --quant q8f32,q8dyn --json-out rows.jsonl
    python -m audiojax_torch.utils.readme_tables --zoo rows.jsonl

Markers in the port's section of README.md, each region headed by the line
of the card the rows were measured on (the rows file's ``{"card": ...}``
line)::

    <!-- torch-zoo-table:begin -->   … <!-- torch-zoo-table:end -->
    <!-- torch-quant-table:begin --> … <!-- torch-quant-table:end -->

The JAX section's ``zoo-table``, ``quant-table`` and ``headline-table``
regions hold the JAX package's numbers and are never touched.  ``--headline``
fills a ``torch-headline-table`` region, which the port's README does not
have until the port has a headline benchmark: without it the flag exits
with a message.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

# registry name → README display name
_DISPLAY = {
    "gtcrn": "GTCRN",
    "h_gtcrn": "H-GTCRN (WPE+AuxIVA in-graph)",
    "ul_unas": "UL-UNAS",
    "dfsmn": "DFSMN",
    "zipenhancer": "ZipEnhancer",
    "mossformergan_se": "MossFormerGAN-SE",
    "mossformer2_se": "MossFormer2-SE-48K",
    "nkf_aec": "NKF-AEC",
    "sdaec": "SDAEC",
    "deep_echo": "Deep-Echo",
    "dfsmn_aec": "DFSMN-AEC cascade",
    "mossformer2_ss": "MossFormer2-SS",
    "melband_roformer": "Mel-Band-Roformer",
    "melband_roformer_stereo": "Mel-Band-Roformer stereo",
    "mossformer2_sr": "MossFormer2-SR",
}

# the port's regions; the JAX section's (zoo-table, quant-table,
# headline-table) are never written
ZOO_TAG = "torch-zoo-table"
QUANT_TAG = "torch-quant-table"
HEADLINE_TAG = "torch-headline-table"


def _fmt_rtf(v: float) -> str:
    return f"{v:.5f}".rstrip("0") if v < 0.01 else f"{v:.4f}".rstrip("0")


def zoo_table(rows: list[dict]) -> str:
    """Merge f32/bf16 rows per model into the README zoo table."""
    by_model: dict[str, dict] = {}
    for r in rows:
        if "error" in r:
            continue
        base, _, dtype = r["model"].partition("+")
        by_model.setdefault(base, {})[dtype or "f32"] = r

    have_mfu = any("mfu_pct" in r for rs in by_model.values() for r in rs.values())
    head = "| Model | RTF | chunk | reference CPU | speedup |"
    sep = "|---|---|---|---|---|"
    if have_mfu:
        head += " TFLOP/s | MFU |"
        sep += "---|---|"
    lines = [head, sep]
    for base, variants in by_model.items():
        f32 = variants.get("f32")
        bf16 = variants.get("bfloat16")
        main = f32 or bf16
        name = _DISPLAY.get(base, base)
        if f32 and bf16:
            name += " (f32 / bf16)"
            rtf = f"{_fmt_rtf(f32['rtf'])} / {_fmt_rtf(bf16['rtf'])}"
            speed = (f"{f32['vs_baseline']}× / {bf16['vs_baseline']}×"
                     if f32.get("vs_baseline") else "—")
        else:
            if bf16 and not f32:
                name += " (bf16)"
            rtf = _fmt_rtf(main["rtf"])
            speed = f"{main['vs_baseline']}×" if main.get("vs_baseline") else "—"
        base_rtf = main.get("baseline_rtf")
        line = (f"| {name} | {rtf} | {main['chunk_s']:.0f} s | "
                f"{base_rtf if base_rtf is not None else '—'} | {speed} |")
        if have_mfu:
            pick = bf16 if (bf16 and "mfu_pct" in bf16) else main
            tf = f"{pick['tflops_per_s']:.2f}" if "tflops_per_s" in pick else "—"
            mfu = f"{pick['mfu_pct']:.1f}%" if "mfu_pct" in pick else "—"
            line += f" {tf} | {mfu} |"
        lines.append(line)
    return "\n".join(lines)


def quant_table(rows: list[dict]) -> str:
    """Quantization-plan rows (``model+q8f32`` / ``model+q8dyn``) with their
    f32 anchor, RTF and SNR-vs-f32 — the measured basis for the README's
    serving-plan recommendation."""
    by_model: dict[str, dict] = {}
    for r in rows:
        if "error" in r:
            continue
        base, _, variant = r["model"].partition("+")
        by_model.setdefault(base, {})[variant or "f32"] = r
    lines = ["| Model | plan | RTF | vs f32 RTF | SNR vs f32 |",
             "|---|---|---|---|---|"]
    for base, variants in by_model.items():
        qplans = [k for k in variants if k.startswith("q8")]
        if not qplans:
            continue
        f32 = variants.get("f32")
        for plan in ("f32", "bfloat16", *sorted(qplans)):
            r = variants.get(plan)
            if r is None:
                continue
            rel = (f"{r['rtf'] / f32['rtf']:.2f}×" if f32 else "—")
            snr = (f"{r['snr_vs_f32_db']:.1f} dB" if "snr_vs_f32_db" in r
                   else ("exact" if plan == "f32" else "—"))
            lines.append(f"| {_DISPLAY.get(base, base)} | {plan} | "
                         f"{_fmt_rtf(r['rtf'])} | {rel} | {snr} |")
    return "\n".join(lines)


def headline_table(line: dict) -> str:
    rows = [
        ("ZipEnhancer RTF (60 s clip, 1.5 s folds, f32)", line["value"],
         "0.32", line["vs_baseline"]),
        ("ZipEnhancer RTF (bf16 compute)", line["zipenhancer_bf16_rtf"],
         "—", line["zipenhancer_bf16_vs_baseline"]),
        ("ZipEnhancer bf16 throughput (8 concurrent clips, per clip)",
         line.get("zipenhancer_bf16_bs8_rtf_per_clip"), "—", None),
        ("GTCRN RTF (60 s clip, folds)", line["gtcrn_rtf"],
         "0.0036", line["gtcrn_vs_baseline"]),
        ("GTCRN streaming RTF (64 ms blocks, host loop)",
         line["gtcrn_stream_rtf_64ms_blocks"], "—", None),
        ("GTCRN streaming RTF (64 ms ticks, chip-side scan)",
         line.get("gtcrn_stream_chip_rtf_64ms_blocks"), "—", None),
    ]
    out = ["| Metric | audiojax | reference (CPU) | speedup |", "|---|---|---|---|"]
    for name, v, ref, speed in rows:
        if v is None:  # older bench line without this row
            continue
        s = f"{speed}×" if speed else f"{1.0 / v:.0f}× real-time"
        out.append(f"| {name} | **{_fmt_rtf(v)}** | {ref} | {s} |")
    return "\n".join(out)


def replace_region(text: str, tag: str, body: str) -> str:
    begin, end = f"<!-- {tag}:begin -->", f"<!-- {tag}:end -->"
    i, j = text.index(begin), text.index(end)
    return text[: i + len(begin)] + "\n" + body + "\n" + text[j:]


def read_rows(path) -> tuple[str | None, list[dict]]:
    """A ``bench_all --json-out`` file: (its card line, its rows)."""
    card, rows = None, []
    for line in Path(path).read_text().splitlines():
        if line.strip():
            r = json.loads(line)
            if set(r) == {"card"}:
                card = r["card"]
            else:
                rows.append(r)
    return card, rows


def _headed(card: str | None, table: str) -> str:
    return f"Card: {card or 'not recorded'}\n\n{table}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="audiojax_torch.utils.readme_tables", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--readme", default=str(Path(__file__).resolve().parents[2] / "README.md"))
    ap.add_argument("--zoo", help="bench_all --json-out rows file (JSON lines)")
    ap.add_argument("--headline", help="a headline benchmark line (JSON)")
    args = ap.parse_args(argv)

    text = Path(args.readme).read_text()
    if args.zoo:
        card, rows = read_rows(args.zoo)
        text = replace_region(text, ZOO_TAG, _headed(card, zoo_table(rows)))
        if f"<!-- {QUANT_TAG}:begin -->" in text and any(
                "+q8" in r.get("model", "") for r in rows):
            text = replace_region(text, QUANT_TAG, _headed(card, quant_table(rows)))
    if args.headline:
        if f"<!-- {HEADLINE_TAG}:begin -->" not in text:
            raise SystemExit(f"{args.readme} has no {HEADLINE_TAG} region: the port has no "
                             "headline benchmark yet")
        line = json.loads(Path(args.headline).read_text())
        text = replace_region(text, HEADLINE_TAG, headline_table(line))
    Path(args.readme).write_text(text)
    print(f"updated {args.readme}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
