"""ragged sparse step path — per-step math in the [P_valid]/[U] domain.

Port of ``paddlebox_tpu/ps/ragged_path.py``.  The pass is lowered to
per-batch CSR plans once, host-side (``data.pass_feed.build_csr_plans``);
the step then touches only the batch's valid occurrences [P] and its
sorted-unique working-set rows [U], never the padded [S, L, B] domain
and never a full-[N] sweep.

Plan (one batch), the JAX package's five arrays:
  seg    [P] int32 — pooled segment s*B + b of each valid occurrence
  inv    [P] int32 — occurrence → [U]-position; position 0 = row 0
  occ_w  [P] f32   — 1 valid / 0 pad (zeroes pad payloads on push)
  u_rows [U] int32 — sorted-unique working-set rows (u_rows[0] == 0)
  u_slot [U] int32 — merged per-row slot id (max over occurrences)

Forward = one [U]-row gather → seqpool by segment → CVM.  Backward =
per-row sums of the occurrence grads into [U] accumulators → the
optimizer rules (``ps.optimizer.apply_push``) on the gathered [U]-row
sub-SoA → one ``index_copy_`` back per field (duplicates only at row 0,
all carrying row 0's untouched values).

Determinism: the JAX package's ``segment_sum`` adds each segment's
terms in operand (canonical) order; both sums here (by ``seg`` for the
pull, by ``inv`` for the push) go through ``sorted_spmm.segment_sum``,
which keeps that order with no float atomics.  Its sort plans are
derived in the step, beside the five-array plan, which stays the JAX
package's.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from paddlebox_tpu_torch.config import SparseSGDConfig
from paddlebox_tpu_torch.ops import sorted_spmm as sp
from paddlebox_tpu_torch.ps import optimizer as sparse_opt
from paddlebox_tpu_torch.ps.embedding import cvm_pooled, mf_values

Tensors = Dict[str, torch.Tensor]

# working-set fields that do not ride the [U]-domain gather/update/scatter
# cycle (quantization sidecars keyed off "mf")
_ROW_FIELDS_SKIP = ("mf_scale",)


def _row_fields(ws: Tensors):
    n = ws["show"].shape[0]
    return [f for f, v in ws.items()
            if f not in _ROW_FIELDS_SKIP and v.dim() >= 1
            and v.shape[0] == n]


def pull_pool_cvm(ws: Tensors, plan: Tuple[torch.Tensor, ...],
                  shape_slb: Tuple[int, int, int],
                  use_cvm: bool = True) -> torch.Tensor:
    """Fused pull + seqpool + CVM from a CSR plan → pooled [B, S, E],
    E = 3 + D (cvm'show, cvm'click, w, mf...).

    Pad occurrences need no mask: inv = 0 points at [U]-position 0 =
    working-set row 0, the reserved all-zero row."""
    seg, inv, occ_w, u_rows, u_slot = plan
    s, l, b = shape_slb
    ur = u_rows.long()
    head = torch.stack([ws["show"][ur], ws["click"][ur], ws["embed_w"][ur]],
                       dim=-1)                                  # [U, 3]
    created = (ws["mf_size"][ur] > 0).to(head.dtype)
    mf_u = mf_values(ws, ws["mf"][ur]) * created[:, None]       # [U, D]
    u_vals = torch.cat([head, mf_u], dim=-1)                    # [U, E]
    pooled = sp.segment_sum(u_vals[inv.long()], seg, s * b)    # [S*B, E]
    return cvm_pooled(pooled.reshape(s, b, -1), use_cvm)        # [B, S, E]


def push_and_update(ws: Tensors, plan: Tuple[torch.Tensor, ...],
                    d_pooled: torch.Tensor, ins_cvm: torch.Tensor,
                    shape_slb: Tuple[int, int, int],
                    cfg: SparseSGDConfig) -> Tensors:
    """Merged push + optimizer update in the [P]/[U] domain, updating
    ``ws`` in place.  d_pooled [B, S, E] (cols 0,1 ignored, replaced by
    ins_cvm per the reference push semantics); ins_cvm [B, 2]."""
    seg, inv, occ_w, u_rows, u_slot = plan
    s, l, b = shape_slb
    u = u_rows.shape[0]
    segl = seg.long()
    b_of = segl % b

    # -- per-occurrence payloads ([P]) -> merged [U] accumulators ---------
    # occ_w zeroes every pad position's payload, so pad occurrences add an
    # exact 0.0 into [U]-position 0 and push_touched never fires there
    d_sb = d_pooled.permute(1, 0, 2).reshape(s * b, -1)         # [S*B, E]
    occ_pay = d_sb[segl]                                        # [P, E]
    pay = torch.cat([
        torch.stack([ins_cvm[b_of, 0] * occ_w, ins_cvm[b_of, 1] * occ_w,
                     occ_pay[:, 2] * occ_w], dim=1),
        occ_pay[:, 3:] * occ_w[:, None]], dim=1)                # [P, 3+D]
    merged = sp.segment_sum(pay, inv, u)                        # [U, 3+D]
    acc = {"g_show": merged[:, 0], "g_click": merged[:, 1],
           "g_embed": merged[:, 2], "g_embedx": merged[:, 3:],
           "slot": u_slot}

    # -- optimizer on the [U]-row frontier only ---------------------------
    ur = u_rows.long()
    fields = _row_fields(ws)
    sub = {f: ws[f][ur] for f in fields}
    new = sparse_opt.apply_push(sub, acc, cfg)

    # -- one scatter back into the working-set SoA ------------------------
    # row 0 appears at [U]-position 0 and at every pad slot of u_rows; all
    # of them were untouched, so every duplicate write carries row 0's
    # original values
    for f in fields:
        ws[f].index_copy_(0, ur, new[f])
    return ws
