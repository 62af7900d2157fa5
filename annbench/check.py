"""The comparison that decides `correct`: every answer the window returned,
judged by the plain reference on the benchmark's own copy of the data.

Numbers compared, each with its limit (`limits` of the traffic mix):
- `missing`: queries of the window that got no answer (a call that raised,
  or fewer rows than queries); limit 0.
- `bad_rows`: answers whose ids leave [0, n), repeat within the row, or
  whose distances are not finite and ascending; limit 0.
- `dist_gap`: the widest gap between a returned distance and the reference's
  distance of the returned id, over the query's true k-th distance. It holds
  the distances the program computed (the hop's K2, the rerank) and the
  label mapping (an id that does not go with its distance). Limit from the
  readings of sound runs and of the control (`control.py`).
- `recall_at_10`: mean recall@k of all answers against the reference's exact
  top-k; it holds the graph the set-up built and the scan's shortlist, which
  `dist_gap` cannot see. Floor (`recall_floor`) from the readings of sound
  runs and of planted faults (`faults.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from annbench import reference


def judge(data, queries, answers, k, metric, limits, missing=0):
    """-> (correct, {name: [value, limit, "<=" or ">="]}, recall).

    data [n, d] and queries [nq, d] are the benchmark's tensors, in the
    configuration's type, on the device the reference runs on; `metric` the
    configuration's, as `registry.form` reads it; answers a list of (lo,
    dists [b, k], ids [b, k]): the answers to queries lo .. lo + b - 1."""
    dev = data.device
    truth_d, truth_i = reference.exact_knn(data, queries, k, metric)
    n = data.shape[0]
    qidx = torch.from_numpy(np.concatenate(
        [np.arange(lo, lo + len(i)) for lo, _, i in answers])).to(dev) if answers else \
        torch.zeros(0, dtype=torch.int64, device=dev)
    if answers:
        ids = torch.from_numpy(np.concatenate([np.asarray(i) for _, _, i in answers])).to(dev).long()
        dists = torch.from_numpy(np.concatenate([np.asarray(d) for _, d, _ in answers])).to(dev).float()
    else:
        ids = torch.zeros((0, k), dtype=torch.int64, device=dev)
        dists = torch.zeros((0, k), device=dev)
    if ids.shape[1:] != (k,) or dists.shape != ids.shape:
        missing += len(qidx)
        ids, dists, qidx = ids[:0, :k], dists[:0, :k], qidx[:0]

    in_range = ((ids >= 0) & (ids < n)).all(1)
    srt = ids.sort(1).values
    distinct = (srt[:, 1:] != srt[:, :-1]).all(1)
    ordered = torch.isfinite(dists).all(1) & (dists[:, 1:] >= dists[:, :-1]).all(1)
    good = in_range & distinct & ordered
    bad_rows = int((~good).sum())

    ref = reference.id_distances(data, queries, qidx[good], ids[good], metric)
    scale = truth_d[qidx[good], k - 1].clamp_min(torch.finfo(torch.float32).tiny)
    gap = ((dists[good] - ref).abs() / scale[:, None]).max() if ref.numel() else torch.tensor(0.0)
    hits = reference.recall_hits(ids, truth_i[qidx]) if len(qidx) else 0
    recall = hits / max(len(qidx) * k, 1)

    numbers = {
        "missing": [int(missing), 0, "<="],
        "bad_rows": [bad_rows, 0, "<="],
        "dist_gap": [float(gap), float(limits["dist_gap"]), "<="],
        "recall_at_10": [recall, float(limits["recall_floor"]), ">="],
    }
    ok = all(v <= lim if op == "<=" else v >= lim for v, lim, op in numbers.values())
    return ok and len(qidx) > 0, numbers, recall


def lines(numbers) -> list[str]:
    """One line a number: its value beside its limit."""
    return [f"check {name}: {v!r} {op} {lim!r}" for name, (v, lim, op) in numbers.items()]
