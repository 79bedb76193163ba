"""Faults planted under a cell's timed path, one function each: it takes
the engine a traffic driver built and breaks it in place. A sound check
reads ``correct`` false for each."""

from __future__ import annotations

import torch


def half_views(predictor) -> None:
    """Half of the batch left out: the TTA mean taken over the unflipped
    view alone."""
    head = predictor.head_from_feats

    def first_view_only(feats, model=None):
        return head(torch.cat([feats[:1]] * feats.shape[0]), model)

    predictor.head_from_feats = first_view_only


def altered_answer(predictor) -> None:
    """An answer altered where it is produced: each chunk's first
    prediction replaced by its complement."""
    chunk = predictor.chunk_features

    def altered(new_frames, carry, shares=None):
        preds, carry = chunk(new_frames, carry, shares)
        preds = preds.clone()
        preds[0] = 1.0 - preds[0]
        return preds, carry

    predictor.chunk_features = altered


FAULTS = {
    "predict": {"half_views": half_views, "altered_answer": altered_answer},
}
