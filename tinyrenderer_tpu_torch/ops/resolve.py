"""Visibility-buffer resolve (port of ops/resolve.py): the per-triangle
resolve table and select + eval (kernel K2, ``csrc/select_eval.cu``).

Every per-triangle quantity folds into one table row: the 1/w denominator
plane, the attribute numerator planes (affine in screen space) as three
component blocks A_x, A_y, A_c, and the flat per-triangle constants. A
pixel's attributes are its winning row's planes evaluated at the pixel
centre, numerator over denominator (perspective-correct interpolation).

The TPU selects each pixel's row with a one-hot matrix product over its
tile's bin because it gathers badly; the winner is always in its tile's
bin, so the port gathers ``table[tri_id]`` directly — the same row,
copied exactly.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import kernels
from .fp import plane

F32 = torch.float32
I32 = torch.int32

N_ATTR = 14        # world3 uv2 normal3 tangent3 bitangent3
N_ATTR_SLIM = 6    # world3 normal3
ROW_D = 3 * (N_ATTR + 1) + 8        # full layout: 53
ROW_D_SLIM = 3 * (N_ATTR_SLIM + 1) + 7   # slim flat-only layout: 28

K2_LAUNCHES = 0    # CUDA launches of the select + eval kernel


@dataclass
class VertexAttrs:
    """Per-vertex interpolation sources (world space)."""

    world: torch.Tensor      # (V, 3)
    uv: torch.Tensor         # (V, 2)
    normal: torch.Tensor     # (V, 3)
    tangent: torch.Tensor    # (V, 3)
    bitangent: torch.Tensor  # (V, 3)

    def rows(self) -> torch.Tensor:
        return torch.cat([self.world, self.uv, self.normal, self.tangent,
                          self.bitangent], dim=1)


def build_gbuffer_table(setup, tri_vidx: torch.Tensor, attrs: VertexAttrs,
                        tri_instance: torch.Tensor,
                        inst_object_id: torch.Tensor,
                        inst_material: torch.Tensor,
                        mat_record: torch.Tensor, mat_flat: torch.Tensor,
                        slim: bool = False) -> torch.Tensor:
    """(T, 53) per-triangle resolve table, or (T, 28) with ``slim``.

    Layout [pw 3 | A_x n | A_y n | A_c n | consts]: full n = 14 attrs
    [world3 uv2 normal3 tangent3 bitangent3] and consts [flat6 record oid];
    slim n = 6 attrs [world3 normal3] and consts [flat6 oid] — the
    flat-only layout, where uv, tangents and the record are never read.
    Rows of invalid triangles are zero."""
    attr_rows = attrs.rows()
    if slim:
        attr_rows = torch.cat([attr_rows[:, 0:3], attr_rows[:, 5:8]], dim=1)
    vidx = tri_vidx.long()
    blocks = [None, None, None]          # A_x, A_y, A_c, channel-first
    pw = [None, None, None]
    for k in range(3):
        iwk = setup.inv_w[:, k]
        awk = attr_rows[vidx[:, k]].T * iwk[None, :]           # (n, T)
        for j in range(3):
            e = setup.rows[:, 3 * k + j]
            term = awk * e[None, :]
            blocks[j] = term if blocks[j] is None else blocks[j] + term
            pw[j] = iwk * e if pw[j] is None else pw[j] + iwk * e
    mat = inst_material.long()[tri_instance.long()]
    consts = [mat_flat[mat].T,
              mat_record[mat].to(F32)[None, :],
              inst_object_id[tri_instance.long()].to(F32)[None, :]]
    if slim:
        consts = [consts[0], consts[2]]
    rows_cf = torch.cat([torch.stack(pw, dim=0)] + blocks + consts, dim=0)
    rows_cf = torch.where(setup.valid[None, :], rows_cf,
                          torch.zeros_like(rows_cf))
    return rows_cf.T.contiguous()


def _layout(D: int) -> tuple[int, int, int]:
    """(n_attr, f32 channels, h channels) of a table width D."""
    if D == ROW_D_SLIM:
        return N_ATTR_SLIM, 4, 9
    if D == ROW_D:
        return N_ATTR, 7, 15
    raise ValueError(f"resolve table width {D} is neither {ROW_D} nor "
                     f"{ROW_D_SLIM}")


def select_eval_ref(tri_id: torch.Tensor, table: torch.Tensor,
                    bf16: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2 (any device).

    (H, W) winner ids + (T, D) table -> channel-first split outputs: slim
    (4, H, W) f32 [world3 oid] + (9, H, W) [normal3 flat6]; full (7, H, W)
    f32 [world3 uv2 record oid] + (15, H, W) [normal3 tangent3 bitangent3
    flat6]. The second output is bf16 with ``bf16`` (round to nearest even),
    else f32. Background pixels (tri_id < 0) select no row: every channel
    is 0, as the reference's empty one-hot sum gives."""
    H, W = tri_id.shape
    T, D = table.shape
    n_attr, cf, _ = _layout(D)
    dev = table.device
    valid = tri_id >= 0
    row = table[tri_id.clamp(0, T - 1).long()]                    # (H, W, D)
    row = torch.where(valid[..., None], row, torch.zeros((), device=dev))
    acc = row.permute(2, 0, 1)                                    # (D, H, W)
    px = torch.arange(W, dtype=F32, device=dev)[None, None, :] + 0.5
    py = torch.arange(H, dtype=F32, device=dev)[None, :, None] + 0.5
    denom = plane(acc[0:1], acc[1:2], acc[2:3], px, py)
    denom = torch.where(denom.abs() > 1e-20, denom,
                        torch.ones((), device=dev))
    ax, ay, ac = 3, 3 + n_attr, 3 + 2 * n_attr
    planes = 3 * (n_attr + 1)
    attrs = plane(acc[ax:ay], acc[ay:ac], acc[ac:planes], px, py) / denom
    consts = acc[planes:]
    n_vec = cf - (len(consts) - 6)       # f32 attribute prefix: 3 or 5
    outf = torch.cat([attrs[:n_vec], consts[6:]], dim=0).contiguous()
    outh = torch.cat([attrs[n_vec:], consts[:6]], dim=0)
    return outf, outh.to(torch.bfloat16 if bf16 else F32).contiguous()


def select_eval(tri_id: torch.Tensor, table: torch.Tensor,
                bf16: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Select + eval: :func:`select_eval_ref`'s contract. CPU tensors take
    the plain version; CUDA tensors launch K2."""
    if table.device.type == "cpu":
        return select_eval_ref(tri_id, table, bf16)
    global K2_LAUNCHES
    H, W = tri_id.shape
    T, D = table.shape
    n_attr, cf, ch = _layout(D)
    if tri_id.dtype != I32 or table.dtype != F32 or T == 0:
        raise ValueError("select_eval takes i32 tri_id and a non-empty f32 "
                         "table")
    tri_id = tri_id.contiguous()
    table = table.contiguous()
    kernels.require_cuda("select_eval", tri_id, table)
    outf = torch.empty((cf, H, W), dtype=F32, device=table.device)
    outh = torch.empty((ch, H, W), dtype=torch.bfloat16 if bf16 else F32,
                       device=table.device)
    code = kernels.library().tr_select_eval(
        tri_id.data_ptr(), table.data_ptr(), outf.data_ptr(), outh.data_ptr(),
        H, W, T, D, n_attr, int(bf16), kernels.stream_handle(table.device))
    kernels.check("tr_select_eval", code)
    K2_LAUNCHES += 1
    return outf, outh
