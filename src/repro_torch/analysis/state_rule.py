"""The rule two runs of the same training steps are held to (``PERF.md`` §2).

Two runs of the same AdamW steps (the card against the CPU, hier against
naive, the port against the reference) add their gradients in different
orders, so their updated states differ by the gradients' rounding.  The
rule holds each group as tightly as that rounding allows:

* m and v per leaf within rtol 2e-4 and an atol of 2e-5 of the leaf's
  largest |m| / v, so a small element is held as tightly as the largest
  gradient's rounding allows;
* every updated param within rtol 2e-4 atol 2e-5, but for the elements
  where AdamW's update is ill-conditioned: sqrt(v_hat) below 100 eps
  (1e-6), where d update / d m = 1 / (sqrt(v_hat) + eps) ~ 1e8 turns a
  gradient rounding of 1e-7 of the leaf's largest into a tenth of the
  update.  Those are excused (their m and v were held above), and counted,
  so a caller can bound how many there are.

A NaN on either side is outside every tolerance, and no non-finite param
is excused.

``state_close`` takes nested dicts ``{"params", "m", "v"}`` of tensors or
numpy arrays (any device; compared on the CPU in float32).
"""

from __future__ import annotations

import numpy as np
import torch

RTOL = 2e-4
ATOL = 2e-5
#: sqrt(v_hat) below this is where AdamW's update is ill-conditioned
ILL_CONDITIONED = 100 * 1e-8


def _leaves_with_path(tree, path=()):
    """(path, leaf) pairs of a nested dict, keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves_with_path(tree[k], path + (k,))]
    return [(path, tree)]


def _f32(x) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    return torch.as_tensor(x).detach().to("cpu", torch.float32)


def state_close(got: dict, want: dict, steps: int, what: str = "state"
                ) -> tuple[int, int, dict]:
    """Hold ``got`` to ``want`` (the updated state after ``steps`` AdamW
    steps, b2 0.95) under the rule above; raise ``AssertionError`` naming
    the first leaf that breaks it.  Returns the excused param count, the
    param element count and the worst |diff| / tolerance of m and v."""
    worst = {"m": 0.0, "v": 0.0}
    for grp in ("m", "v"):
        pairs = zip(_leaves_with_path(got[grp]), _leaves_with_path(want[grp]))
        for (path, a), (_, b) in pairs:
            a, b = _f32(a), _f32(b)
            atol = ATOL * b.abs().max().item()
            tol = atol + RTOL * b.abs()
            diff = (a - b).abs()
            bad = int((~(diff <= tol)).sum())
            if bad:
                raise AssertionError(
                    f"{what} {grp} {'/'.join(path)}: {bad} of {b.numel()} "
                    f"elements outside rtol {RTOL} atol {ATOL} of the "
                    f"leaf's largest (a NaN is outside)")
            if b.numel():        # all close: 0 / 0 only where both are 0
                ratio = torch.where(diff == 0, 0.0, diff / tol)
                worst[grp] = max(worst[grp], ratio.max().item())
    c2 = 1.0 - 0.95 ** steps
    excused = total = 0
    for (path, a), (_, b), (_, vb) in zip(
            *(_leaves_with_path(t) for t in (got["params"], want["params"],
                                             want["v"]))):
        a, b, vb = _f32(a), _f32(b), _f32(vb)
        total += b.numel()
        bad = ~((a - b).abs() <= ATOL + RTOL * b.abs())
        if not bad.any():
            continue
        ill = (((vb[bad] / c2).sqrt() < ILL_CONDITIONED)
               & a[bad].isfinite() & b[bad].isfinite())
        if not bool(ill.all()):
            where = bad.nonzero()[~ill][:3]
            cells = [f"{tuple(i.tolist())}: {a[tuple(i)].item():.6g} vs "
                     f"{b[tuple(i)].item():.6g}, sqrt(v_hat) "
                     f"{(vb[tuple(i)] / c2).sqrt().item():.3g}"
                     for i in where]
            raise AssertionError(
                f"{what} params {'/'.join(path)}: {int(bad.sum())} elements "
                f"outside rtol {RTOL} atol {ATOL}, {int((~ill).sum())} of "
                f"them where AdamW's update is well conditioned "
                f"({'; '.join(cells)})")
        excused += int(bad.sum())
    return excused, total, worst
