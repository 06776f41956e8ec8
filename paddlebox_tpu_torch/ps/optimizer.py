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

Every rule of the JAX package's ``OPTIMIZERS`` is here: ``adagrad``,
``shared_adam`` (SparseAdamSharedOptimizer :330), ``adam`` (per-dim
moments, SparseAdamOptimizer :148), ``std_adagrad`` (per-dim g2sum,
sparse_sgd_rule.h:109) and ``naive`` (plain SGD, sparse_sgd_rule.h:77).
Each is elementwise over axis 0, so a caller may pass the whole working
set or a gathered [U]-row sub-SoA with matching accumulators (the ragged
lowering does).  An expand table's ``mf_ex`` trains under ``adagrad``
only; the other four rules leave ``mf_ex`` / ``mf_ex_g2sum`` as they
are, as the JAX package's do.
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


def push_touched(ws: Tensors, acc: Tensors, row0: int = 0) -> torch.Tensor:
    """THE touched mask: rows this push updates (g_show > 0, reserved row
    0 excluded).  ``row0``: the global row of ``ws``'s first row (a
    block of the working set)."""
    row = torch.arange(ws["show"].shape[0], device=ws["show"].device)
    return (acc["g_show"] > 0) & (row != -row0)


def _common_stats(ws: Tensors, acc: Tensors, cfg: SparseSGDConfig,
                  row0: int = 0):
    """Shared show/click/delta accumulation + touched mask (the common
    prologue of every rule, ≙ optimizer.cuh.h:84-101)."""
    touched = push_touched(ws, acc, row0)
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
                         dims_row=None, row0: int = 0) -> Tensors:
    """One merged push → new working-set values (≙ HashTable::update with
    SparseAdagradOptimizer, hashtable_kernel.cu + optimizer.cuh.h:31)."""
    touched, show, click, delta = _common_stats(ws, acc, cfg, row0)
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

    out = {"show": show, "click": click, "delta_score": delta, "slot": slot,
           "embed_w": embed_w, "embed_g2sum": embed_g2sum,
           "mf_size": mf_size, "mf_g2sum": mf_g2sum, "mf": mf}
    if "mf_ex" in ws and "g_embedx_ex" in acc:
        # the expand (NNCross) embedding trains like mf, under the same
        # mf_touched gate and bounds; a push without its grads (the fast
        # and reference lowerings) leaves it as it is
        out["mf_ex"], out["mf_ex_g2sum"] = _adagrad_update(
            ws["mf_ex"], ws["mf_ex_g2sum"], acc["g_embedx_ex"], g_show,
            cfg.mf_learning_rate, cfg.mf_initial_g2sum, cfg.mf_min_bound,
            cfg.mf_max_bound, mf_touched, ws["mf_ex"].shape[1])
    return out


def _shared_adam_group(w, m1, m2, b1p, b2p, g, scale, lr, beta1, beta2,
                       min_bound, max_bound, touched, n_dim,
                       eps: float = 1e-8):
    """≙ SparseAdamSharedOptimizer::update_value_work
    (optimizer.cuh.h:341-386): ONE shared (moment1, moment2, beta-pow) per
    row for the whole group; per-dim new moments derive from the shared
    old moment, w updates per dim, then the stored moments are the per-dim
    means and the beta powers decay once.  n_dim: the group width, or
    per-row [N] ints for dynamic mf dims."""
    safe_scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    ratio = lr * torch.sqrt(1.0 - b2p) / (1.0 - b1p)
    if w.dim() == 2:
        sg = g / safe_scale[:, None]
        new_m1 = beta1 * m1[:, None] + (1 - beta1) * sg
        new_m2 = beta2 * m2[:, None] + (1 - beta2) * sg * sg
        upd = new_m1 / (torch.sqrt(new_m2) + eps)
        if torch.is_tensor(n_dim):
            # dynamic mf dims: only the row's true columns update, and the
            # shared moments are means over those columns alone
            dmask = (torch.arange(w.shape[1], device=w.device)[None, :]
                     < n_dim[:, None]).to(w.dtype)
            upd = upd * dmask
            m1_out = torch.sum(new_m1 * dmask, dim=1) / n_dim
            m2_out = torch.sum(new_m2 * dmask, dim=1) / n_dim
        else:
            m1_out = torch.mean(new_m1, dim=1)
            m2_out = torch.mean(new_m2, dim=1)
        new_w = w + ratio[:, None] * upd
        mask = touched[:, None]
    else:
        sg = g / safe_scale
        new_m1 = beta1 * m1 + (1 - beta1) * sg
        new_m2 = beta2 * m2 + (1 - beta2) * sg * sg
        new_w = w + ratio * (new_m1 / (torch.sqrt(new_m2) + eps))
        m1_out, m2_out = new_m1, new_m2
        mask = touched
    new_w = torch.clamp(new_w, min_bound, max_bound)
    return (torch.where(mask, new_w, w),
            torch.where(touched, m1_out, m1),
            torch.where(touched, m2_out, m2),
            torch.where(touched, b1p * beta1, b1p),
            torch.where(touched, b2p * beta2, b2p))


def _group_dim(ws: Tensors, cfg: SparseSGDConfig, slot, dims_row):
    """The embedx group width: per-row [N] dims under dynamic mf dims,
    else the table's mf width."""
    if dims_row is None:
        dims_row = _dym_dims(cfg, slot, ws["mf"].shape[1])
    return dims_row if dims_row is not None else ws["mf"].shape[1]


def _reset_beta_pows(create, b1p, b2p, cfg: SparseSGDConfig):
    """Rows created by this push restart their beta powers at the decay
    rates (creation init, optimizer.cuh.h:260-268, :436-441)."""
    return (torch.where(create, torch.full_like(b1p, cfg.beta1_decay_rate),
                        b1p),
            torch.where(create, torch.full_like(b2p, cfg.beta2_decay_rate),
                        b2p))


def sparse_adam_apply(ws: Tensors, acc: Tensors, cfg: SparseSGDConfig,
                      dims_row=None, row0: int = 0) -> Tensors:
    """SparseAdamShared (optimizer.cuh.h:330-477): shared per-row moments
    in embed_gsum/embed_g2sum (+ beta powers) for the lr weight and
    mf_gsum/mf_g2sum for the embedx group.  Needs the adam state fields
    (feature_value.ADAM_FIELDS)."""
    touched, show, click, delta = _common_stats(ws, acc, cfg, row0)
    slot = torch.where(touched, acc["slot"], ws["slot"])

    embed_w, e_m1, e_m2, e_b1, e_b2 = _shared_adam_group(
        ws["embed_w"], ws["embed_gsum"], ws["embed_g2sum"],
        ws["embed_b1p"], ws["embed_b2p"], acc["g_embed"], acc["g_show"],
        cfg.learning_rate, cfg.beta1_decay_rate, cfg.beta2_decay_rate,
        cfg.mf_min_bound, cfg.mf_max_bound, touched, 1, cfg.ada_epsilon)

    group_dim = _group_dim(ws, cfg, slot, dims_row)
    create, mf_size, mf_touched = _mf_create(ws, cfg, touched, show, click,
                                             group_dim)
    mf, m_m1, m_m2, m_b1, m_b2 = _shared_adam_group(
        ws["mf"], ws["mf_gsum"], ws["mf_g2sum"], ws["mf_b1p"], ws["mf_b2p"],
        acc["g_embedx"], acc["g_show"], cfg.mf_learning_rate,
        cfg.beta1_decay_rate, cfg.beta2_decay_rate,
        cfg.mf_min_bound, cfg.mf_max_bound, mf_touched, group_dim,
        cfg.ada_epsilon)
    m_b1, m_b2 = _reset_beta_pows(create, m_b1, m_b2, cfg)

    return {"show": show, "click": click, "delta_score": delta,
            "slot": slot,
            "embed_w": embed_w, "embed_g2sum": e_m2, "embed_gsum": e_m1,
            "embed_b1p": e_b1, "embed_b2p": e_b2,
            "mf_size": mf_size, "mf_g2sum": m_m2, "mf_gsum": m_m1,
            "mf_b1p": m_b1, "mf_b2p": m_b2, "mf": mf}


def sparse_naive_apply(ws: Tensors, acc: Tensors, cfg: SparseSGDConfig,
                       dims_row=None, row0: int = 0) -> Tensors:
    """SparseNaiveSGDRule (sparse_sgd_rule.h:77): plain SGD with bound
    clipping and show-scaled grads; the g2sum fields are left alone."""
    touched, show, click, delta = _common_stats(ws, acc, cfg, row0)
    slot = torch.where(touched, acc["slot"], ws["slot"])
    g_show = acc["g_show"]
    safe_scale = torch.where(g_show > 0, g_show, torch.ones_like(g_show))
    embed_w = torch.where(
        touched,
        torch.clamp(ws["embed_w"] + cfg.learning_rate * acc["g_embed"]
                    / safe_scale, cfg.min_bound, cfg.max_bound),
        ws["embed_w"])
    group_dim = _group_dim(ws, cfg, slot, dims_row)
    create, mf_size, mf_touched = _mf_create(ws, cfg, touched, show, click,
                                             group_dim)
    mf = torch.where(
        mf_touched[:, None],
        torch.clamp(ws["mf"] + cfg.mf_learning_rate * acc["g_embedx"]
                    / safe_scale[:, None], cfg.mf_min_bound,
                    cfg.mf_max_bound),
        ws["mf"])
    return {"show": show, "click": click, "delta_score": delta,
            "slot": slot, "embed_w": embed_w, "mf_size": mf_size, "mf": mf}


def sparse_std_adagrad_apply(ws: Tensors, acc: Tensors, cfg: SparseSGDConfig,
                             dims_row=None, row0: int = 0) -> Tensors:
    """StdAdaGradSGDRule (sparse_sgd_rule.h:109): adagrad with a per-dim
    g2sum for the embedx group (field mf_g2sum_d [N, D]) instead of the
    shared per-row scalar; the 1-dim lr weight is plain adagrad."""
    touched, show, click, delta = _common_stats(ws, acc, cfg, row0)
    slot = torch.where(touched, acc["slot"], ws["slot"])
    lr_embed = torch.where(
        slot == cfg.nodeid_slot,
        torch.full_like(ws["embed_w"], cfg.learning_rate),
        torch.full_like(ws["embed_w"], cfg.feature_learning_rate))
    g_show = acc["g_show"]
    safe_scale = torch.where(g_show > 0, g_show, torch.ones_like(g_show))
    ratio = lr_embed * torch.sqrt(cfg.initial_g2sum /
                                  (cfg.initial_g2sum + ws["embed_g2sum"]))
    sg = acc["g_embed"] / safe_scale
    embed_w = torch.where(
        touched,
        torch.clamp(ws["embed_w"] + sg * ratio, cfg.min_bound, cfg.max_bound),
        ws["embed_w"])
    embed_g2sum = torch.where(touched, ws["embed_g2sum"] + sg * sg,
                              ws["embed_g2sum"])

    group_dim = _group_dim(ws, cfg, slot, dims_row)
    create, mf_size, mf_touched = _mf_create(ws, cfg, touched, show, click,
                                             group_dim)
    sg_mf = acc["g_embedx"] / safe_scale[:, None]           # [N, D]
    ratio_d = cfg.mf_learning_rate * torch.sqrt(
        cfg.mf_initial_g2sum / (cfg.mf_initial_g2sum + ws["mf_g2sum_d"]))
    mask = mf_touched[:, None]
    mf = torch.where(mask, torch.clamp(ws["mf"] + sg_mf * ratio_d,
                                       cfg.mf_min_bound, cfg.mf_max_bound),
                     ws["mf"])
    mf_g2sum_d = torch.where(mask, ws["mf_g2sum_d"] + sg_mf * sg_mf,
                             ws["mf_g2sum_d"])
    return {"show": show, "click": click, "delta_score": delta, "slot": slot,
            "embed_w": embed_w, "embed_g2sum": embed_g2sum,
            "mf_size": mf_size, "mf_g2sum_d": mf_g2sum_d, "mf": mf}


def sparse_adam_dim_apply(ws: Tensors, acc: Tensors, cfg: SparseSGDConfig,
                          dims_row=None, row0: int = 0) -> Tensors:
    """Per-dimension SparseAdam (sparse_sgd_rule.h:126 /
    optimizer.cuh.h:148): embedx keeps full [N, D] moments (mf_gsum_d /
    mf_g2sum_d) with shared per-row beta-power trackers; the 1-dim lr
    weight uses the scalar moment fields (the shared rule at dim 1)."""
    eps = cfg.ada_epsilon
    b1, b2 = cfg.beta1_decay_rate, cfg.beta2_decay_rate
    touched, show, click, delta = _common_stats(ws, acc, cfg, row0)
    slot = torch.where(touched, acc["slot"], ws["slot"])
    g_show = acc["g_show"]
    safe_scale = torch.where(g_show > 0, g_show, torch.ones_like(g_show))

    embed_w, e_m1, e_m2, e_b1, e_b2 = _shared_adam_group(
        ws["embed_w"], ws["embed_gsum"], ws["embed_g2sum"],
        ws["embed_b1p"], ws["embed_b2p"], acc["g_embed"], g_show,
        cfg.learning_rate, b1, b2, cfg.mf_min_bound, cfg.mf_max_bound,
        touched, 1, eps)

    group_dim = _group_dim(ws, cfg, slot, dims_row)
    create, mf_size, mf_touched = _mf_create(ws, cfg, touched, show, click,
                                             group_dim)
    sg = acc["g_embedx"] / safe_scale[:, None]              # [N, D]
    new_m1 = b1 * ws["mf_gsum_d"] + (1 - b1) * sg
    new_m2 = b2 * ws["mf_g2sum_d"] + (1 - b2) * sg * sg
    lr_t = cfg.mf_learning_rate * torch.sqrt(1.0 - ws["mf_b2p"]) \
        / (1.0 - ws["mf_b1p"])
    new_mf = torch.clamp(ws["mf"] + lr_t[:, None]
                         * (new_m1 / (torch.sqrt(new_m2) + eps)),
                         cfg.mf_min_bound, cfg.mf_max_bound)
    mask = mf_touched[:, None]
    mf = torch.where(mask, new_mf, ws["mf"])
    mf_gsum_d = torch.where(mask, new_m1, ws["mf_gsum_d"])
    mf_g2sum_d = torch.where(mask, new_m2, ws["mf_g2sum_d"])
    mf_b1p = torch.where(mf_touched, ws["mf_b1p"] * b1, ws["mf_b1p"])
    mf_b2p = torch.where(mf_touched, ws["mf_b2p"] * b2, ws["mf_b2p"])
    mf_b1p, mf_b2p = _reset_beta_pows(create, mf_b1p, mf_b2p, cfg)

    return {"show": show, "click": click, "delta_score": delta,
            "slot": slot,
            "embed_w": embed_w, "embed_gsum": e_m1, "embed_g2sum": e_m2,
            "embed_b1p": e_b1, "embed_b2p": e_b2,
            "mf_size": mf_size, "mf": mf,
            "mf_gsum_d": mf_gsum_d, "mf_g2sum_d": mf_g2sum_d,
            "mf_b1p": mf_b1p, "mf_b2p": mf_b2p}


OPTIMIZERS = {
    "adagrad": sparse_adagrad_apply,
    "shared_adam": sparse_adam_apply,
    "adam": sparse_adam_dim_apply,
    "std_adagrad": sparse_std_adagrad_apply,
    "naive": sparse_naive_apply,
}


def apply_push(ws: Tensors, acc: Tensors, cfg: SparseSGDConfig,
               dims_row=None, row0: int = 0) -> Tensors:
    """Apply one merged push to ``ws`` IN PLACE and return it.

    dims_row: optional per-row [N] mf dims (≙ CtrDymfAccessor); rules
    divide and mask by the row's true width.  A rule returns only the
    fields it changes; the others keep their storage and values.
    ``row0``: the global row of ``ws``'s first row, when ``ws`` is one
    block of the working set (every rule is elementwise over rows, and
    only the reserved global row 0 is never touched).

    The JAX step donates the working-set buffers to the jitted step and
    gets new ones back; here each field's new values are copied into the
    existing tensor instead, so the working set keeps its storage for the
    whole pass and callers holding ``ws`` see the update."""
    out = OPTIMIZERS[cfg.optimizer](ws, acc, cfg, dims_row, row0)
    # ctr_double accessor support: exact pass-delta counters ride along
    # (end_pass merges them into the host's f64 stats)
    if "show_acc" in ws:
        touched = push_touched(ws, acc, row0)
        out["show_acc"] = torch.where(
            touched, ws["show_acc"] + acc["g_show"], ws["show_acc"])
        out["click_acc"] = torch.where(
            touched, ws["click_acc"] + acc["g_click"], ws["click_acc"])
    for f, v in out.items():
        ws[f].copy_(v)
    return ws
