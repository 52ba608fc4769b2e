"""Deployment manifest — the metadata contract that makes serving model-agnostic.

A copy of ``audiojax.runtime.manifest`` (the port imports nothing of the JAX
package): the same required keys, fields and derived runtime configuration,
so a manifest drives both packages' sessions identically.  Run as a
module it is the manifest inspector (:func:`main`).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any

__all__ = ["Manifest", "REQUIRED_KEYS", "TASKS", "validate_manifest_dict", "main"]

REQUIRED_KEYS = (
    "manifest_version",
    "producer",
    "model_name",
    "task",
    "model_family",
    "input_audio_dtype",
    "output_audio_dtype",
    "in_sample_rate",
    "out_sample_rate",
    "model_sample_rate",
    "input_audio_length",
    "input_to_output_scale",
    "max_dynamic_audio_seconds",
    "normalize_audio_default",
    "normalize_target_rms",
)

TASKS = ("denoise", "aec", "separation", "vocal_separation", "super_resolution")


@dataclasses.dataclass
class Manifest:
    model_name: str
    task: str
    model_family: str
    in_sample_rate: int
    out_sample_rate: int
    model_sample_rate: int
    input_audio_length: int
    producer: str = "audiojax"
    manifest_version: int = 1
    input_audio_dtype: str = "INT16"
    output_audio_dtype: str = "INT16"
    input_to_output_scale: float | None = None
    max_dynamic_audio_seconds: int = 120
    normalize_audio_default: bool = False
    normalize_target_rms: float = 4096.0
    # optional geometry / policy keys
    fold_window_length: int = 0
    batch_window_seconds: float = 0.0
    batch_fold_inference_default: bool = False
    window_type: str | None = None
    nfft: int | None = None
    window_length: int | None = None
    hop_length: int | None = None
    pad_mode: str | None = None
    center_pad: bool | None = None
    input_channels: int = 1
    output_channels: int = 1
    num_audio_inputs: int = 1
    output_sources: int = 1
    pad_head: int = 0
    enc_stride: int = 0
    overlap_length: int = 0  # host OLA overlap for super-resolution stitching
    feature_kind: str | None = None
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.task not in TASKS:
            raise ValueError(f"unknown task {self.task!r}; expected one of {TASKS}")
        if self.input_to_output_scale is None:
            self.input_to_output_scale = float(self.out_sample_rate) / float(self.in_sample_rate)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    def save(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.to_json())
        return path

    @classmethod
    def load(cls, path) -> "Manifest":
        return cls.from_dict(json.loads(Path(path).read_text()))

    @classmethod
    def from_dict(cls, data: dict) -> "Manifest":
        validate_manifest_dict(data)
        fields = {f.name for f in dataclasses.fields(cls)}
        known = {k: v for k, v in data.items() if k in fields}
        unknown = {k: v for k, v in data.items() if k not in fields}
        # copy 'extra' rather than alias the caller's dict
        known["extra"] = {**known.get("extra", {}), **unknown}
        return cls(**known)

    def runtime_config(self) -> dict:
        """Derive the host windowing geometry."""
        fold = self.fold_window_length
        fold_input = (
            max(1, int(round(fold * self.in_sample_rate / self.model_sample_rate))) if fold else 0
        )
        return {
            "IN_SAMPLE_RATE": self.in_sample_rate,
            "OUT_SAMPLE_RATE": self.out_sample_rate,
            "MODEL_SAMPLE_RATE": self.model_sample_rate,
            "INPUT_TO_OUTPUT_SCALE": self.input_to_output_scale,
            "INPUT_AUDIO_LENGTH": self.input_audio_length,
            "BATCH_WINDOW_SECONDS": self.batch_window_seconds,
            "HOP_LENGTH": self.hop_length or 0,
            "FOLD_WINDOW_LENGTH": fold,
            "FOLD_INPUT_LENGTH": fold_input,
            "BATCH_FOLD_INFERENCE": self.batch_fold_inference_default,
            "MAX_DYNAMIC_AUDIO_SECONDS": self.max_dynamic_audio_seconds,
            "NORMALIZE_AUDIO": self.normalize_audio_default,
            "NORMALIZE_TARGET_RMS": self.normalize_target_rms,
            "INPUT_CHANNELS": self.input_channels,
            "OUTPUT_CHANNELS": self.output_channels,
            "NUM_AUDIO_INPUTS": self.num_audio_inputs,
            "OUTPUT_SOURCES": self.output_sources,
            "PAD_HEAD": self.pad_head,
            "ENC_STRIDE": self.enc_stride,
            "OVERLAP_LENGTH": self.overlap_length,
            "SCALE_FACTOR": self.input_to_output_scale,
        }


def validate_manifest_dict(data: dict) -> None:
    """Fail-closed required-key check."""
    missing = [k for k in REQUIRED_KEYS if k not in data or data[k] in (None, "")]
    if missing:
        raise KeyError(f"manifest is missing required keys: {missing}")


def main(argv=None) -> int:
    """Manifest inspector: print every key, exit 1 when a required key is missing.

        python -m audiojax_torch.runtime.manifest <artifact_dir_or_manifest.json>
    """
    import argparse
    import sys

    ap = argparse.ArgumentParser(description="audiojax_torch manifest inspector")
    ap.add_argument("path", help="manifest.json or artifact directory")
    args = ap.parse_args(argv)
    path = Path(args.path)
    if path.is_dir():
        path = path / "manifest.json"
    data = json.loads(path.read_text())
    for k in sorted(data):
        print(f"{k} = {data[k]!r}")
    try:
        validate_manifest_dict(data)
    except KeyError as e:
        print(str(e), file=sys.stderr)
        return 1
    print(f"OK: all {len(REQUIRED_KEYS)} required keys present")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
