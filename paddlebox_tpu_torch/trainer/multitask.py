"""Multi-task trainer (MMoE path).

Port of ``paddlebox_tpu/trainer/multitask.py``: one metric set per task
head (≙ the multi-metric registry with name-keyed MetricMsg,
box_wrapper.h:769-792).  The step is ``SparseTrainer``'s reference
lowering with these differences: labels are [B, T], the model's
``forward_multi`` gives [B, T] logits, the loss is the mean of the
per-task masked BCE, the push's show/click come from task 0 (the CTR
head), and the AUC buckets accumulate per task into stacked tables.
Extra feed planes reach ``forward_multi`` as keyword arguments; the
per-user AUC (``uid_slot``) scores task 0.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from paddlebox_tpu_torch.data.batch_pack import BatchPacker
from paddlebox_tpu_torch.metrics import auc as auc_mod
from paddlebox_tpu_torch.metrics.auc import AucCalculator, accumulate_auc
from paddlebox_tpu_torch.trainer.trainer import SparseTrainer


def make_multi_auc_state(n_tasks: int, table_size: int,
                         device: torch.device = None
                         ) -> Dict[str, torch.Tensor]:
    return {
        "pos": torch.zeros((n_tasks, table_size), dtype=torch.float32,
                           device=device),
        "neg": torch.zeros((n_tasks, table_size), dtype=torch.float32,
                           device=device),
        "scalars": torch.zeros((n_tasks, auc_mod.N_SCALARS),
                               dtype=torch.float32, device=device),
    }


class MultiTaskSparseTrainer(SparseTrainer):
    def __init__(self, engine, model, feed_config, batch_size: int,
                 label_slots: List[str], **kw):
        """``model`` has ``forward_multi`` (e.g. ``models.mmoe.MMoE``).
        The step is the reference lowering in f32: ``amp`` and any other
        explicit ``sparse_path`` raise."""
        if kw.get("amp"):
            raise ValueError("MultiTaskSparseTrainer trains in f32 (the "
                             "JAX package's multi-task step has no amp)")
        super().__init__(engine, model, feed_config, batch_size,
                         label_slot=label_slots[0], **kw)
        if self.sparse_path not in ("auto", "reference"):
            raise ValueError("MultiTaskSparseTrainer trains on the "
                             "reference lowering only, not "
                             f"{self.sparse_path!r}")
        self.label_slots = list(label_slots)
        self.n_tasks = len(label_slots)
        self.packer = BatchPacker(feed_config, batch_size,
                                  label_slot=self.label_slots)
        self.auc_state = make_multi_auc_state(self.n_tasks,
                                              self.auc_table_size,
                                              self.device)
        self.task_aucs = [AucCalculator(self.auc_table_size)
                          for _ in range(self.n_tasks)]

    def _resolve_path(self) -> str:
        super()._resolve_path()       # lifecycle and serving-freeze checks
        return "reference"

    def _ins_cvm(self, labels: torch.Tensor) -> torch.Tensor:
        """show = 1, click = task 0's label (the CTR head feeds the PS
        counters)."""
        return torch.stack([torch.ones_like(labels[:, 0]), labels[:, 0]],
                           dim=1)

    def _loss_and_preds(self, x, dense, labels, valid, extras=None):
        logits = self.model.forward_multi(
            x, dense, **self._model_extras(extras))          # [B, T]
        w = valid.to(torch.float32)[:, None]
        per = F.binary_cross_entropy_with_logits(logits, labels,
                                                 reduction="none")
        loss = torch.sum(per * w) / torch.clamp(
            torch.sum(w) * self.n_tasks, min=1.0)
        return loss, torch.sigmoid(logits.detach())

    def _accumulate_metrics(self, preds, labels, valid) -> None:
        st = self.auc_state
        for t in range(self.n_tasks):
            # row views: the in-place updates land in the stacked tables
            accumulate_auc({"pos": st["pos"][t], "neg": st["neg"][t],
                            "scalars": st["scalars"][t]},
                           preds[:, t], labels[:, t], valid)

    def _finalize_metrics(self, auc_state) -> Dict[str, float]:
        per_task = self.task_metrics()
        out = dict(per_task[0])
        for t, m in enumerate(per_task):
            out[f"task{t}_auc"] = m["auc"]
        # per-user AUC (uid_slot) scores task 0, the CTR head
        self._finalize_wuauc(out)
        return out

    def task_metrics(self) -> List[Dict[str, float]]:
        state = {k: v.cpu().numpy() for k, v in self.auc_state.items()}
        out = []
        for t, calc in enumerate(self.task_aucs):
            calc.reset()
            calc.merge_device_state({k: v[t] for k, v in state.items()})
            out.append(calc.compute())
        return out

    def reset_metrics(self) -> None:
        self.auc_state = make_multi_auc_state(self.n_tasks,
                                              self.auc_table_size,
                                              self.device)
        self.auc.reset()
        if self.wuauc is not None:
            self.wuauc.reset()
