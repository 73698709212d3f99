"""What decides ``correct``: a frame the window produced, against the plain
reference's frame of the same inputs.

The numbers, each the worst over the checked frames:

- ``pick_mismatch``: the share of pixels whose object id differs;
- ``depth_rel``: the mean relative depth difference (each pixel's at
  most 1) over the pixels where both show the same object;
- ``hdr_rel``: the summed absolute HDR difference over the reference's
  summed HDR (every pixel and channel);
- ``sdr_off``: the share of 8-bit channels that differ by more than 1.

Where the reference gives a second frame (an atlas depth at a bfloat16
rounding tie, which float32 rounding decides), each pixel is held to the
nearer of the two.

Each has a limit of its own per cell, in ``limits/<workload>.json``.
"""

from __future__ import annotations

import torch

NUMBERS = ("pick_mismatch", "depth_rel", "hdr_rel", "sdr_off")


def compare(prog, ref) -> dict:
    """The numbers of one frame: ``prog`` and ``ref`` carry ``pick_id``,
    ``depth``, ``hdr`` and ``sdr`` of one shape."""
    p_id, r_id = prog.pick_id.long(), ref.pick_id.long()
    same = (p_id == r_id) & (r_id > 0)
    rel = ((prog.depth - ref.depth).abs()
           / ref.depth.abs().clamp(min=1e-30)).clamp(max=1.0)[same]
    hdr_den = ref.hdr.abs().sum().clamp(min=1e-30)
    hdr = (prog.hdr - ref.hdr).abs().sum(-1)
    sdr = (prog.sdr.int() - ref.sdr.int()).abs()
    if ref.hdr_alt is not None:
        hdr = torch.minimum(hdr, (prog.hdr - ref.hdr_alt).abs().sum(-1))
        alt = (prog.sdr.int() - ref.sdr_alt.int()).abs()
        sdr = torch.where((alt.amax(-1) < sdr.amax(-1))[..., None], alt, sdr)
    return {"pick_mismatch": (p_id != r_id).double().mean().item(),
            "depth_rel": rel.double().mean().item() if rel.numel() else 0.0,
            "hdr_rel": (hdr.sum() / hdr_den).item(),
            "sdr_off": (sdr > 1).double().mean().item()}


def worst(readings: list) -> dict:
    """The largest of each number over frames (NaN counts as failing)."""
    out = {}
    for k in NUMBERS:
        vals = [r[k] for r in readings]
        out[k] = float("nan") if any(v != v for v in vals) else max(vals)
    return out


def judge(numbers: dict, limits: dict) -> dict:
    """``{name: {"value": v, "limit": l}}`` for every number; a number
    without a limit, or NaN, fails."""
    return {k: {"value": numbers[k], "limit": limits.get(k)} for k in NUMBERS}


def passed(checks: dict) -> bool:
    return all(c["limit"] is not None and c["value"] == c["value"]
               and c["value"] <= c["limit"] for c in checks.values())
