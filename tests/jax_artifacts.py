"""The JAX-written artifact committed under ``tests/data/`` for the port.

``tests/data/jax_gtcrn_artifact/`` holds ``params.msgpack`` and
``manifest.json`` exactly as the JAX package's ``save_artifact`` writes them
for GTCRN at its full (default) width, from ``jax.random.PRNGKey(SEED)``, with
the config recorded in the manifest as the exporters record it.  The card's
machine has no ``flax`` to write one; ``chip_smoke.py`` serves this one there,
and ``tests/test_torch_msgpack.py`` regenerates it and asserts the bytes are
equal.  To write it again:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/jax_artifacts.py
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

GTCRN_ARTIFACT = Path(__file__).resolve().parent / "data" / "jax_gtcrn_artifact"
SEED = 0


def write_jax_gtcrn_artifact(path) -> Path:
    import jax

    from audiojax.runtime import registry
    from audiojax.runtime.checkpoint import save_artifact

    spec = registry.get("gtcrn")
    cfg = spec.make_config()
    manifest = spec.make_manifest(cfg)
    manifest = dataclasses.replace(
        manifest, extra={**manifest.extra, "config": dataclasses.asdict(cfg)})
    return save_artifact(path, spec.init_params(jax.random.PRNGKey(SEED), cfg), manifest)


if __name__ == "__main__":
    print(write_jax_gtcrn_artifact(GTCRN_ARTIFACT))
