"""Checkpoint importers: upstream torch checkpoints → the port's parameter trees.

Counterpart of ``audiojax.importers``.  ``import_checkpoint(model, ckpt)``
applies the same fusion recipes (float64 numpy) and returns a nested dict of
float32 numpy arrays in the JAX package's layout, equal to what the JAX
package's importer returns; ``audiojax_torch.params.params_from_numpy`` turns
it into the port's tensors, and ``runtime.export`` writes it as an artifact.

Fail-closed: every checkpoint tensor must be read by the recipe.  An unread
key means the upstream layout drifted, and the import aborts with the
leftover keys instead of dropping weights.  ``report_path`` writes a JSON
audit report with the same keys as the JAX package's.

The port has an importer for every family it serves, the fourteen the JAX
package serves (Mel-Band Roformer's mono and stereo names share one).
"""
from __future__ import annotations

import json
import re
from pathlib import Path

from . import common
from .common import KeyTracker, unwrap_state_dict
from .deep_echo import import_deep_echo
from .dfsmn import import_dfsmn
from .dfsmn_aec import import_dfsmn_aec
from .gtcrn import import_gtcrn, import_h_gtcrn
from .melband import import_melband
from .mossformer2_se import import_mossformer2_se
from .mossformer2_ss import import_mossformer2_ss
from .mossformer_sr import import_mossformer_sr
from .mossformergan_se import import_mossformergan_se
from .nkf import import_nkf
from .sdaec import import_sdaec
from .ul_unas import import_ul_unas
from .zipenhancer import import_zipenhancer

_IMPORTERS = {
    "dfsmn": import_dfsmn,
    "gtcrn": import_gtcrn,
    "mossformergan_se": import_mossformergan_se,
    "zipenhancer": import_zipenhancer,
    "mossformer2_ss": import_mossformer2_ss,
    "mossformer2_se": import_mossformer2_se,
    "ul_unas": import_ul_unas,
    "nkf_aec": import_nkf,
    "sdaec": import_sdaec,
    "deep_echo": import_deep_echo,
    "dfsmn_aec": import_dfsmn_aec,
    "melband_roformer": import_melband,
    "melband_roformer_stereo": import_melband,
    "mossformer2_sr": import_mossformer_sr,
    "h_gtcrn": import_h_gtcrn,
}

# torch bookkeeping buffers that carry no weights — ignored, not drift.
# BatchNorm running_mean/running_var are not here: the fusion recipes fold
# them into the conv, so an unread running stat is a recipe fault and aborts.
_IGNORED = re.compile(r"num_batches_tracked$|^_metadata")


def import_checkpoint(model_name: str, ckpt, *, strict: bool = True, report_path=None, **kw):
    """Upstream state dict (or a wrapper of one) → numpy parameter tree.

    ``kw`` goes to the family's importer (``cfg=`` for all but GTCRN,
    H-GTCRN and DFSMN; Mel-Band's also takes ``stem=``; UL-UNAS's, NKF's,
    SDAEC's and Deep-Echo's take it and need none; DFSMN-AEC's reads its
    backend from it and also takes ``cmvn=``).  With ``strict`` (the default)
    unread checkpoint keys raise ``ValueError``; a key the recipe needs and
    the checkpoint lacks raises ``KeyError``."""
    if model_name not in _IMPORTERS:
        raise KeyError(
            f"no importer registered for {model_name!r}; available: {sorted(_IMPORTERS)}"
        )
    tracker = KeyTracker(unwrap_state_dict(ckpt))
    params = _IMPORTERS[model_name](tracker, **kw)

    leftover = [k for k in tracker.unconsumed if not _IGNORED.search(k)]
    ignored = [k for k in tracker.unconsumed if _IGNORED.search(k)]
    report = {
        "model": model_name,
        "checkpoint_keys": len(tracker),
        "consumed": len(tracker.consumed),
        "ignored_buffers": ignored,
        "unconsumed": leftover,
    }
    if report_path is not None:
        p = Path(report_path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(report, indent=2))
    if strict and leftover:
        head = leftover[:20]
        raise ValueError(
            f"import drift for {model_name!r}: {len(leftover)} checkpoint keys were "
            f"not consumed by the recipe (first {len(head)}): {head}. "
            "Pass strict=False to import anyway."
        )
    return params


__all__ = ["common", "import_checkpoint", "import_deep_echo", "import_dfsmn",
           "import_dfsmn_aec", "import_gtcrn", "import_h_gtcrn", "import_melband",
           "import_mossformer_sr", "import_mossformergan_se", "import_mossformer2_se",
           "import_mossformer2_ss", "import_nkf", "import_sdaec", "import_ul_unas",
           "import_zipenhancer"]
