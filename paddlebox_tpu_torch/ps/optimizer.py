"""Device-side sparse optimizers over the pass working set.

Port of ``paddlebox_tpu/ps/optimizer.py`` (≙ heter_ps/optimizer.cuh.h
SparseAdagradOptimizer :31): whole-table elementwise updates over the
merged per-row push accumulators (zero for untouched rows), masked by
``touched = g_show > 0`` so untouched rows keep their exact bits.

Exact semantics of dy_mf_update_value (optimizer.cuh.h:82-130):
  show  += g_show ; click += g_click
  delta_score += nonclk_coeff*(g_show-g_click) + clk_coeff*g_click
  embed_w: adagrad with lr scaled by sqrt(g0/(g0+g2sum)), grad scaled by
           1/g_show, clip to [min_bound, max_bound], g2sum += mean sq grad
  mf: created lazily when nonclk_coeff*(show-click)+clk_coeff*click crosses
      mf_create_thresholds (:104-112); then same adagrad with mf_* params.
Row 0 (reserved zero/padding row) is never updated.

Only the default rule (``adagrad``, config.py) is ported; the other rules
of the JAX package's ``OPTIMIZERS`` raise until they are.
"""

from __future__ import annotations

from typing import Dict

import torch

from paddlebox_tpu_torch.config import SparseSGDConfig

Tensors = Dict[str, torch.Tensor]


def _adagrad_update(w, g2sum, g, scale, lr, initial_g2sum, min_bound,
                    max_bound, touched, n_dim):
    """≙ update_value_work (optimizer.cuh.h:43-73), vectorized over rows.

    w: [N] or [N,D]; g2sum: [N]; g: same shape as w; scale: [N] (g_show).
    n_dim: the embedx group width — a scalar, or per-row [N] ints for
    dynamic mf dims (the mean-square divisor is the row's TRUE dim).
    """
    safe_scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    ratio = lr * torch.sqrt(initial_g2sum / (initial_g2sum + g2sum))
    if w.dim() == 2:
        scaled_grad = g / safe_scale[:, None]
        new_w = w + scaled_grad * ratio[:, None]
        add_g2sum = torch.sum(scaled_grad * scaled_grad, dim=1) / n_dim
    else:
        scaled_grad = g / safe_scale
        new_w = w + scaled_grad * ratio
        add_g2sum = scaled_grad * scaled_grad
    new_w = torch.clamp(new_w, min_bound, max_bound)
    mask = touched if w.dim() == 1 else touched[:, None]
    return (torch.where(mask, new_w, w),
            torch.where(touched, g2sum + add_g2sum, g2sum))


def push_touched(ws: Tensors, acc: Tensors) -> torch.Tensor:
    """THE touched mask: rows this push updates (g_show > 0, reserved row
    0 excluded)."""
    row = torch.arange(ws["show"].shape[0], device=ws["show"].device)
    return (acc["g_show"] > 0) & (row != 0)


def _common_stats(ws: Tensors, acc: Tensors, cfg: SparseSGDConfig):
    """Shared show/click/delta accumulation + touched mask (the common
    prologue of every rule, ≙ optimizer.cuh.h:84-101)."""
    touched = push_touched(ws, acc)
    show = torch.where(touched, ws["show"] + acc["g_show"], ws["show"])
    click = torch.where(touched, ws["click"] + acc["g_click"], ws["click"])
    delta = torch.where(
        touched,
        ws["delta_score"] + cfg.nonclk_coeff * (acc["g_show"] - acc["g_click"])
        + cfg.clk_coeff * acc["g_click"],
        ws["delta_score"])
    return touched, show, click, delta


def _mf_create(ws: Tensors, cfg: SparseSGDConfig, touched, show, click,
               mf_dim):
    """Lazy mf creation on the post-accumulation show/click
    (optimizer.cuh.h:104-112); rows created this push keep their candidate
    init (the reference returns right after initialization, :113-127).
    mf_dim may be per-row [N] for dynamic dims."""
    score = cfg.nonclk_coeff * (show - click) + cfg.clk_coeff * click
    create = touched & (ws["mf_size"] == 0) & \
        (score >= cfg.mf_create_thresholds)
    if not torch.is_tensor(mf_dim):
        mf_dim = torch.full_like(ws["mf_size"], mf_dim)
    mf_size = torch.where(create, mf_dim.to(ws["mf_size"].dtype),
                          ws["mf_size"])
    mf_touched = touched & (ws["mf_size"] > 0)
    return create, mf_size, mf_touched


def _dym_dims(cfg: SparseSGDConfig, slot: torch.Tensor, mf_dim: int):
    """Per-row mf dims from the merged slot ids via a where-chain
    (≙ CtrDymfAccessor resolving dim by slot).  None when the config has
    no dynamic dims."""
    if not cfg.slot_mf_dims:
        return None
    dims = torch.full_like(slot, mf_dim, dtype=torch.int32)
    for sid, d in cfg.slot_mf_dims:
        dims = torch.where(slot == sid, torch.full_like(dims, d), dims)
    return dims


def sparse_adagrad_apply(ws: Tensors, acc: Tensors, cfg: SparseSGDConfig,
                         dims_row=None) -> Tensors:
    """One merged push → new working-set values (≙ HashTable::update with
    SparseAdagradOptimizer, hashtable_kernel.cu + optimizer.cuh.h:31)."""
    touched, show, click, delta = _common_stats(ws, acc, cfg)
    slot = torch.where(touched, acc["slot"], ws["slot"])

    # embed_w (1-dim lr weight); slot-dependent lr (optimizer.cuh.h:52-56)
    lr_embed = torch.where(
        slot == cfg.nodeid_slot,
        torch.full_like(ws["embed_w"], cfg.learning_rate),
        torch.full_like(ws["embed_w"], cfg.feature_learning_rate))
    g_show = acc["g_show"]
    safe_scale = torch.where(g_show > 0, g_show, torch.ones_like(g_show))
    ratio = lr_embed * torch.sqrt(cfg.initial_g2sum /
                                  (cfg.initial_g2sum + ws["embed_g2sum"]))
    sg = acc["g_embed"] / safe_scale
    new_embed = torch.clamp(ws["embed_w"] + sg * ratio, cfg.min_bound,
                            cfg.max_bound)
    embed_w = torch.where(touched, new_embed, ws["embed_w"])
    embed_g2sum = torch.where(touched, ws["embed_g2sum"] + sg * sg,
                              ws["embed_g2sum"])

    # lazy mf creation on the *post-accumulation* show/click
    # (optimizer.cuh.h:104-112)
    mf_dim = ws["mf"].shape[1]
    if dims_row is None:
        dims_row = _dym_dims(cfg, slot, mf_dim)
    group_dim = dims_row if dims_row is not None else mf_dim
    create, mf_size, mf_touched = _mf_create(ws, cfg, touched, show, click,
                                             group_dim)
    mf, mf_g2sum = _adagrad_update(
        ws["mf"], ws["mf_g2sum"], acc["g_embedx"], g_show,
        cfg.mf_learning_rate, cfg.mf_initial_g2sum, cfg.mf_min_bound,
        cfg.mf_max_bound, mf_touched, group_dim)

    return {"show": show, "click": click, "delta_score": delta, "slot": slot,
            "embed_w": embed_w, "embed_g2sum": embed_g2sum,
            "mf_size": mf_size, "mf_g2sum": mf_g2sum, "mf": mf}


def _not_ported(name: str):
    def apply(ws, acc, cfg, dims_row=None):
        raise NotImplementedError(
            f"sparse optimizer rule {name!r} is not ported to the PyTorch "
            "package yet (ROADMAP: port of the remaining optimizer rules)")
    return apply


OPTIMIZERS = {
    "adagrad": sparse_adagrad_apply,
    "shared_adam": _not_ported("shared_adam"),
    "adam": _not_ported("adam"),
    "std_adagrad": _not_ported("std_adagrad"),
    "naive": _not_ported("naive"),
}


def apply_push(ws: Tensors, acc: Tensors, cfg: SparseSGDConfig,
               dims_row=None) -> Tensors:
    """Apply one merged push to ``ws`` IN PLACE and return it.

    The JAX step donates the working-set buffers to the jitted step and
    gets new ones back; here each field's new values are copied into the
    existing tensor instead, so the working set keeps its storage for the
    whole pass and callers holding ``ws`` see the update."""
    out = OPTIMIZERS[cfg.optimizer](ws, acc, cfg, dims_row)
    # ctr_double accessor support: exact pass-delta counters ride along
    # (end_pass merges them into the host's f64 stats)
    if "show_acc" in ws:
        touched = push_touched(ws, acc)
        out["show_acc"] = torch.where(
            touched, ws["show_acc"] + acc["g_show"], ws["show_acc"])
        out["click_acc"] = torch.where(
            touched, ws["click_acc"] + acc["g_click"], ws["click_acc"])
    for f, v in out.items():
        ws[f].copy_(v)
    return ws
