"""Whether the timed path's answers are correct.

During the window a seeded sample (`Sampler`) keeps, for each input pair
of the pool, one of the midpoints the timed path returned for it. Once
the window has closed and the program is freed, the plain reference
(`reference.emavfi`, float32, TF32 off) computes the midpoint of each
sampled pair from the same uint8 frames, and `judge` compares:

- `off2_pct`: the largest, over the sampled midpoints, of the share of
  pixel values (in %) that differ by more than 2 uint8 levels between the
  program's midpoint and the reference's; at most the cell's limit. Two
  levels is above what bfloat16 rounding alone moves a value (its last
  rounding of the midpoint is worth up to one level); the RMS
  difference, printed beside it, is not compared: that rounding floor
  makes up most of it;
- `failed`: answers that never came or came as an error; at most 0;
- `sampled`: midpoints compared; at least the pool's size.
"""

from __future__ import annotations

import sys

import numpy as np


class Sampler:
    """One answer for each input pair, drawn from `seed`: for each pair a
    reservoir of one over every answer the window gave for it, so the
    compared set holds every pair of the pool whatever the window's
    length."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng([seed, 1])
        self.seen: dict = {}
        self.kept: dict = {}

    def offer(self, pair: int, frame: np.ndarray) -> None:
        n = self.seen.get(pair, 0) + 1
        self.seen[pair] = n
        if n == 1 or self.rng.integers(0, n) == 0:
            self.kept[pair] = np.array(frame, copy=True)

    @property
    def items(self) -> list:
        """(pair index, uint8 midpoint) for each pair answered."""
        return sorted(self.kept.items(), key=lambda kv: kv[0])


def off2_pct(got: np.ndarray, ref: np.ndarray) -> float:
    d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    return float(100.0 * np.mean(d > 2))


def rms_levels(got: np.ndarray, ref: np.ndarray) -> float:
    d = got.astype(np.float64) - ref.astype(np.float64)
    return float(np.sqrt(np.mean(d * d)))


def reference_midpoints(config: dict, pool: tuple, pairs, device,
                        precision: str = "float32") -> dict:
    """{pair index: the reference's uint8 midpoint} for each pair."""
    from vfibench.manifest import REPO
    from vfibench.reference.emavfi import Reference

    cfg = dict(config, checkpoint=str(REPO / config["checkpoint"]),
               flow_checkpoint=str(REPO / config["flow_checkpoint"]))
    ref = Reference(cfg, device=device, precision=precision)
    f0, f1 = pool
    idx = sorted(set(pairs))
    out = ref.midpoints_u8(f0[idx], f1[idx])
    return dict(zip(idx, out))


def judge(cell: dict, samples: list, failed: int, pool: tuple,
          device) -> dict:
    """The compared numbers, each with its limit, in the order printed."""
    limits = cell["check"]
    worst = None
    if samples:
        ref = reference_midpoints(cell["config_spec"], pool,
                                  [p for p, _ in samples], device)
        worst = max(off2_pct(m, ref[p]) for p, m in samples)
        print(f"rms_levels (not compared) "
              f"{max(rms_levels(m, ref[p]) for p, m in samples)}",
              file=sys.stderr)
    return {
        "off2_pct": {"value": worst, "limit": limits["off2_pct"]},
        "failed": {"value": failed, "limit": 0},
        "sampled": {"value": len(samples),
                    "limit": cell["params"]["pool"]},
    }


def correct(checks: dict) -> bool:
    off, failed, sampled = (checks[k]["value"] for k in
                            ("off2_pct", "failed", "sampled"))
    return (off is not None and off <= checks["off2_pct"]["limit"]
            and failed <= 0 and sampled >= checks["sampled"]["limit"])


def print_checks(checks: dict) -> None:
    """The compared numbers beside their limits, as the last lines on
    standard error."""
    for name, c in checks.items():
        kind = "at least" if name == "sampled" else "at most"
        print(f"check {name} {c['value']} {kind} {c['limit']}",
              file=sys.stderr, flush=True)
