"""Tile planner for the Hopper deconv and conv kernels.

The JAX package's planner sized a TPU grid step against 8 MiB of VMEM,
charging every float at 2 bytes.  The CUDA kernels here (``csrc/igemm.cuh``)
are implicit GEMMs with a fixed 128-row tile and a 16-deep (tap, channel)
stage; what a layer decides is the output-channel tile ``block_co`` (16, 32
or 64, the smallest that covers the layer's per-group output channels), and
what the budget bounds is the static shared memory of one block, counted at
the operands' true widths, against the 227 KB an sm_90 block may use.
Plans differ from the TPU's by design: there is no leading-dim tile and no
halo, because no block carries anything to another.

The backward adds the dw kernel (``csrc/deconv_dw.cu``), a GEMM whose
reduction runs over every input position: its plan picks the tile of the
unstrided operand's channels (``block_a``) and how many row splits the
reduction takes so that small-output, long-reduction layers still fill the
card; a second pass sums the splits in a fixed order.  ``BackwardPlan``
pairs it with the dx launch's forward-kernel plan.
"""

from __future__ import annotations

import dataclasses

# the most shared memory one sm_90 block may use (227 KB)
SMEM_BUDGET = 232448

# The instantiated tile shapes of csrc/igemm.cuh: rows per block, (tap,
# channel) pairs per stage, and threads per block for each block_co.
BLOCK_M = 128
BLOCK_CI = 16
KERNEL_TILES = {16: 128, 32: 128, 64: 256}


@dataclasses.dataclass(frozen=True)
class DeconvTilePlan:
    """One layer's tile decision for the conv or deconv kernel.

    ``step_smem_bytes`` is the modeled static shared memory of one block
    (operand stages plus the per-row coordinate table); ``overflows`` says
    it exceeds ``smem_budget``.
    """
    block_m: int
    block_ci: int
    block_co: int
    threads: int
    step_smem_bytes: int
    smem_budget: int

    @property
    def overflows(self) -> bool:
        return self.step_smem_bytes > self.smem_budget

    def describe(self) -> str:
        return (f"m{self.block_m}_ci{self.block_ci}_co{self.block_co}"
                f"_t{self.threads}_smem{self.step_smem_bytes}")


def step_byte_model(*, in_dtype_bytes: int = 4,
                    w_dtype_bytes: int | None = None):
    """``step_bytes(block_m, block_ci, block_co)``: static shared memory of
    one block — the A stage ``[block_ci][block_m + 1]`` at the activation
    width, the B stage ``[block_ci][block_co]`` at the weight width, and
    four int32 coordinates per row."""
    w_bytes = in_dtype_bytes if w_dtype_bytes is None else w_dtype_bytes

    def step_bytes(block_m: int, block_ci: int, block_co: int) -> int:
        return (block_ci * (block_m + 1) * in_dtype_bytes
                + block_ci * block_co * w_bytes
                + 4 * block_m * 4)

    return step_bytes


def plan_uniform_tiles(cin: int, cout: int, *, mode: str = "deconv",
                       smem_budget: int = SMEM_BUDGET,
                       block_ci: int | None = None,
                       block_co: int | None = None,
                       groups: int = 1, in_dtype_bytes: int = 4,
                       w_dtype_bytes: int | None = None) -> DeconvTilePlan:
    """Pick the output-channel tile for one layer and model its smem.

    ``block_co`` defaults to the smallest instantiated tile that covers the
    per-group output channels (64 past that); explicit ``block_ci`` /
    ``block_co`` must name an instantiated tile.
    """
    if mode not in ("deconv", "conv"):
        raise ValueError(f"unknown mode {mode!r}; expected 'deconv'|'conv'")
    if cin % groups or cout % groups:
        raise ValueError(f"groups={groups} must divide cin={cin}, "
                         f"cout={cout}")
    if block_ci is not None and block_ci != BLOCK_CI:
        raise ValueError(f"block_ci={block_ci}: the kernels are built with "
                         f"{BLOCK_CI} (tap, channel) pairs per stage")
    if block_co is None:
        cog = cout // groups
        block_co = next((b for b in sorted(KERNEL_TILES) if b >= cog),
                        max(KERNEL_TILES))
    elif block_co not in KERNEL_TILES:
        raise ValueError(f"block_co={block_co}: the kernels are built for "
                         f"{sorted(KERNEL_TILES)}")
    step = step_byte_model(in_dtype_bytes=in_dtype_bytes,
                           w_dtype_bytes=w_dtype_bytes)
    return DeconvTilePlan(block_m=BLOCK_M, block_ci=BLOCK_CI,
                          block_co=block_co, threads=KERNEL_TILES[block_co],
                          step_smem_bytes=step(BLOCK_M, BLOCK_CI, block_co),
                          smem_budget=smem_budget)


def grid_blocks(plan: DeconvTilePlan, rows: int, cout: int, groups: int,
                phases: int = 1) -> int:
    """CUDA blocks one launch runs: row tiles x per-group channel tiles x
    groups x phases (``rows`` counts the batch; ``phases`` is S^d for the
    deconv, whose rows are per-phase positions)."""
    co_tiles = -(-(cout // groups) // plan.block_co)
    return -(-rows // plan.block_m) * co_tiles * groups * phases


# -- the dw kernel (csrc/deconv_dw.cu) ----------------------------------------

# block_a -> block_c: the instantiated tiles of the dw kernel.
# Keep in step with csrc/deconv_dw.cu (launch_dw_typed).
DW_TILES = {16: 128, 32: 128, 64: 64}
DW_BLOCK_K = 16
# the split of the reduction aims at this many blocks (4 per SM of 132)
# and gives no split fewer than DW_MIN_ROWS rows
DW_TARGET_BLOCKS = 4 * 132
DW_MIN_ROWS = 512


def dw_step_bytes(block_a: int, block_k: int, block_c: int,
                  dtype_bytes: int = 4) -> int:
    """Static shared memory of one dw block: the A stage ``[block_k]
    [block_a]`` and the gathered B stage ``[block_k][block_c]``, both at
    the operands' width, four int32 coordinates per staged row and four
    per column."""
    return (block_k * (block_a + block_c) * dtype_bytes
            + 4 * block_k * 4 + 4 * block_c * 4)


@dataclasses.dataclass(frozen=True)
class DwTilePlan:
    """One layer's tile decision for the dw kernel: ``block_a`` channels
    of the unstrided operand A per block (the kernel pairs each with its
    ``DW_TILES`` column tile), and the reduction cut into ``splits``
    slices of ``rows_per_split`` rows, each its own block, summed
    afterwards in a fixed order."""
    block_a: int
    splits: int
    rows_per_split: int


def plan_dw_tiles(a_channels: int, b_channels: int, taps: int, rows: int, *,
                  groups: int = 1) -> DwTilePlan:
    """Pick the dw kernel's tile and the split of its reduction.

    ``a_channels``/``b_channels`` are the operands' total channels (A is
    indexed by the reduction position, B gathered at each tap), ``taps``
    is prod(K) and ``rows`` the positions summed over (batch included).
    ``block_a`` is the smallest tile covering A's per-group channels (64
    past that).  The split fills ``DW_TARGET_BLOCKS`` blocks when the
    output alone gives fewer, without cutting slices below
    ``DW_MIN_ROWS`` rows.
    """
    if a_channels % groups or b_channels % groups:
        raise ValueError(f"groups={groups} must divide {a_channels} and "
                         f"{b_channels}")
    if rows < 1 or taps < 1:
        raise ValueError(f"dw over {rows} rows and {taps} taps")
    ag, bg = a_channels // groups, b_channels // groups
    block_a = next((b for b in sorted(DW_TILES) if b >= ag), max(DW_TILES))
    out_blocks = (groups * -(-ag // block_a)
                  * -(-(taps * bg) // DW_TILES[block_a]))
    splits, per = split_rows(rows, min(-(-DW_TARGET_BLOCKS // out_blocks),
                                       max(1, rows // DW_MIN_ROWS)))
    return DwTilePlan(block_a=block_a, splits=splits, rows_per_split=per)


def split_rows(rows: int, splits: int) -> tuple[int, int]:
    """``(splits, rows_per_split)`` for cutting ``rows`` into at most
    ``splits`` slices of whole ``DW_BLOCK_K``-row stages (at most 65,535:
    the slices are a grid dimension)."""
    splits = max(1, min(int(splits), rows, 65535))
    per = -(-rows // splits)
    per = -(-per // DW_BLOCK_K) * DW_BLOCK_K
    return -(-rows // per), per


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """One layer's backward: the dx launch runs the OTHER forward kernel
    (conv's dx on the deconv kernel and the reverse) with the channel
    roles swapped, planned as that kernel; dw runs the dw kernel, whose
    instantiated tiles all fit the budget (``dw_step_bytes``)."""
    dx: DeconvTilePlan
    dw: DwTilePlan

    @property
    def overflows(self) -> bool:
        return self.dx.overflows

    @property
    def smem_budget(self) -> int:
        return self.dx.smem_budget

    def describe(self) -> str:
        return (f"dx:{self.dx.describe()} dw:a{self.dw.block_a}"
                f"_split{self.dw.splits}x{self.dw.rows_per_split}")
