"""The system under test: the port's serving session for a configuration.

The only module of the benchmark that imports the port (``audiojax_torch``).
It builds the model through the port's registry (``make_module``,
``make_manifest``) on the benchmark's weights, checks that the manifest's
window geometry is the one the configuration file states, and serves it
through ``Session.process``.  A forward pre-hook on the model counts the
windows each call runs, which ``Session`` rounds up to its buckets.
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

KEYS = {"window": "INPUT_AUDIO_LENGTH", "pad_head": "PAD_HEAD", "overlap": "OVERLAP_LENGTH",
        "sample_rate": "IN_SAMPLE_RATE", "scale": "INPUT_TO_OUTPUT_SCALE",
        "inputs": "NUM_AUDIO_INPUTS", "channels": "INPUT_CHANNELS"}


def geometry_of(runtime: dict) -> dict:
    """The serving geometry, under the configuration file's keys, of a
    manifest's runtime configuration."""
    out = {key: runtime[name] for key, name in KEYS.items()}
    out["normalize_rms"] = runtime["NORMALIZE_TARGET_RMS"] if runtime["NORMALIZE_AUDIO"] else None
    return out


def start_builds(names: list):
    """Start the port's kernel builds (``ops._build.load``) side by side;
    returns a function that waits for them.  A built library is only loaded."""
    from audiojax_torch.ops import _build

    pool = ThreadPoolExecutor(max_workers=max(1, len(names)))
    futures = [pool.submit(_build.load, n) for n in names]

    def wait() -> None:
        try:
            for f in futures:
                f.result()
        finally:
            pool.shutdown(wait=True)

    return wait


class Program:
    """``Session`` over the registry's model for ``config``, on ``device``."""

    def __init__(self, config: dict, params: dict, device, compute_dtype: str | None = None):
        from audiojax_torch.runtime import registry
        from audiojax_torch.runtime.session import Session

        spec = registry.get(config["program"]["registry"])
        fields = {k: tuple(v) if isinstance(v, list) else v for k, v in config["model"].items()}
        cfg = spec.make_config(**fields)
        if compute_dtype is not None:
            cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
        self.module = spec.make_module(params, cfg)
        manifest = spec.make_manifest(cfg)
        geometry = geometry_of(manifest.runtime_config())
        for key, value in geometry.items():
            if value != config["serving"][key]:
                raise ValueError(f"the program's manifest gives {key} = {value}, the "
                                 f"configuration states {config['serving'][key]}")
        self.session = Session(self.module, manifest, device=device,
                               bucket_windows=config["serving"]["bucket"] == "pow2")
        self.batches: list[int] = []
        self.module.register_forward_pre_hook(lambda m, args: self.batches.append(args[0].shape[0]))

    def process(self, *inputs):
        """One request, its int16 inputs; (outputs, the session's elapsed_s)."""
        r = self.session.process(*inputs)
        return r.outputs, r.elapsed_s
