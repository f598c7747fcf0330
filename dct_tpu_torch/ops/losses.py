"""Loss and metric ops (counterpart of ``dct_tpu/ops/losses.py``).

The same math as the reference: weighted sums plus a weight total, in f32.
Padding rows carry weight 0, so ``sum / count`` is the mean over real rows,
and a ``(sum, count)`` pair adds up exactly across batches. Logits are
``[..., C]`` with integer labels ``[...]`` and weights broadcastable to the
labels (``[B]`` rows, or ``[B, S]`` / ``[B, S, H]`` per position).
"""

from __future__ import annotations

import torch


def masked_cross_entropy(logits, labels, weight):
    """Returns (weighted_loss_sum, weight_sum); the mean is sum / count."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(log_probs, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    w = weight.float()
    return (nll * w).sum(), w.sum()


def masked_accuracy(logits, labels, weight):
    """Returns (weighted_correct_sum, weight_sum)."""
    preds = logits.float().argmax(dim=-1)
    correct = (preds == labels).float()
    w = weight.float()
    return (correct * w).sum(), w.sum()


def masked_binary_counts(logits, labels, weight, *, positive: int = 1):
    """Weighted (tp, fp, fn) sums for the ``positive`` class."""
    preds = logits.float().argmax(dim=-1)
    w = weight.float()
    is_pos_pred = (preds == positive).float()
    is_pos_label = (labels == positive).float()
    tp = (is_pos_pred * is_pos_label * w).sum()
    fp = (is_pos_pred * (1.0 - is_pos_label) * w).sum()
    fn = ((1.0 - is_pos_pred) * is_pos_label * w).sum()
    return tp, fp, fn


def precision_recall_f1(tp: float, fp: float, fn: float):
    """Host-side finalization of the global count sums."""
    precision = tp / (tp + fp) if (tp + fp) > 0 else 0.0
    recall = tp / (tp + fn) if (tp + fn) > 0 else 0.0
    f1 = (
        2.0 * precision * recall / (precision + recall)
        if (precision + recall) > 0
        else 0.0
    )
    return precision, recall, f1


def softmax_probs(logits):
    return torch.softmax(logits.float(), dim=-1)
