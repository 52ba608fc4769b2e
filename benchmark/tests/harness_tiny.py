"""Tiny configurations of the benchmark's models, for the CPU tests: every
kind of layer kept, widths and depths cut so a window serves in seconds."""
from __future__ import annotations

from benchmark import cell as cells

TINY = {
    "mossformergan_se": dict(emb_dim=16, emb_ks=2, uv_channels=24, n_blocks=1, dense_depth=2,
                             lorder=4, mf_hidden=32, mf_vdim=16, mf_qk=16, mf_rot=8,
                             dw_kernel=7, attn_heads=2, attn_q_ch=2, attn_v_ch=4),
    "mossformer2_ss": dict(dim=64, depth=2, group_size=16, qk_dim=32, vu_dim=96,
                           fsmn_inner=32, dw_kernel=5, rot_dim=8, lorder=5),
}


def tiny_cell(workload: str, strata: int = 3, checked: int = 2):
    """The cell ``workload`` at its tiny configuration, with ``strata`` clips
    a round and ``checked`` requests checked."""
    cell = cells.load(workload)
    cell.config["model"].update(TINY[cell.config["program"]["registry"]])
    cell.mix["lengths_s"]["strata"] = strata
    cell.mix["check"]["requests"] = checked
    return cell
