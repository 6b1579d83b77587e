"""Fused key-domain value iteration: a Pallas kernel for the GPU (Triton).

The XLA path (:func:`..tabular_key.key_value_iteration`) runs one Bellman
backup per sweep as separate array programs: it materialises the seven
action branches of the (K, Cd, 4, H, W) value tensor, gathers along the
key-location axis for the drop action and writes the carried-key row back
with ``.at[CARRIED].set``.  This kernel runs every sweep of one layout
inside one program, so a sweep reads V once from the L1/L2 caches and
writes it once:

* one program per layout; the sweep loop runs inside the kernel;
* V lives in two per-layout buffers in device memory (Jacobi ping-pong),
  which are kernel outputs; a block-wide barrier separates the sweeps;
* the 64 cell rows of the key-location axis and the carried-key row are
  separate buffers, so every block is a power of two (the raster is
  padded to ``P``, a power of two);
* each (config, direction) slab is processed in row chunks of
  ``(KB, P)``: turns read the neighbouring direction slabs, forward and
  toggle are gathers at the front cell and the toggled config, pickup
  selects the carried row, and the carried row's drop is a gather of the
  front cell's row.

Branch semantics mirror :func:`..tabular_key._backup` term for term; the
branch maximum is taken before the discount, which is exact in floating
point because scaling by ``gamma > 0`` is monotone.  Terminal rewards
(goal ahead, or the pickup target ahead with empty hands) are 1.0, above
every discounted branch, so they are applied after the maximum.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from minigrid_dynamicprogramming_tpu.dp.tabular_key import (
    _DIRS,
    KeyTabularLayout,
    _door_tables,
    _front_index,
    _shift_from,
)

__all__ = ["pallas_key_value_iteration"]

# Elements per (key-location rows x raster) block, and warps per program:
# the fastest of the four settings timed on the H100 at 512 DoorKey-8x8
# layouts x 96 sweeps (blocks of 16 or 32 rows with 4 warps, 16 or 64 rows
# with 8; a DoorKey-8x8 row is 64 cells).  Wider rasters take fewer rows
# per block, so the registers per thread stay the same.
BLOCK_ELEMS = 4096
NUM_WARPS = 8

# Bit layout of the per-(dir, config, cell) flag word.
_WALK, _CLOSED, _UNLOCK, _GOAL, _LAVA, _TARGET, _DROP = range(7)
_CFG_SHIFT = 8  # config reached by toggling the door ahead


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _layout_tables(layout: KeyTabularLayout, P: int):
    """Per-layout kernel inputs over the raster padded to ``P`` cells:
    flags (4, C, P) int32 and the front cell's raster index (4, P) int32
    (-1 out of bounds)."""
    h, w = layout.base_walk.shape
    HW = h * w
    _, door_block, bitmask, locked_cell, closed_cell = _door_tables(layout)
    C = door_block.shape[0]
    unlock_cell = locked_cell & layout.door_unlockable[
        jnp.clip(layout.door_id, 0, layout.n_doors - 1)
    ][None]
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    target_cell = (xs == layout.target_pos[0]) & (ys == layout.target_pos[1])
    cfg = jnp.arange(C, dtype=jnp.int32)[:, None, None]
    base = layout.base_walk[None] & ~door_block

    def bit(x, b):
        return x.astype(jnp.int32) << b

    flags, front = [], []
    for dxy in _DIRS:
        fidx = _front_index(h, w, dxy)
        droppable = (
            _shift_from(layout.base_empty, dxy)
            & (fidx >= 0)
            & ~_shift_from(layout.door_id >= 0, dxy)
        )
        per_cell = (
            bit(_shift_from(layout.goal, dxy), _GOAL)
            | bit(_shift_from(layout.lava, dxy), _LAVA)
            | bit(_shift_from(target_cell, dxy), _TARGET)
            | bit(droppable, _DROP)
        )
        f = (
            bit(_shift_from(base, dxy), _WALK)
            | bit(_shift_from(closed_cell, dxy), _CLOSED)
            | bit(_shift_from(unlock_cell, dxy), _UNLOCK)
            | per_cell[None]
            | ((cfg | _shift_from(bitmask, dxy)[None]) << _CFG_SHIFT)
        )
        flags.append(f.reshape(C, HW))
        front.append(fidx.reshape(HW))
    flags = jnp.pad(jnp.stack(flags), ((0, 0), (0, 0), (0, P - HW)))
    front = jnp.pad(
        jnp.stack(front), ((0, 0), (0, P - HW)), constant_values=-1
    )
    return flags, front


def _key_vi_kernel(
    flags_ref, front_ref, vc_a, vr_a, vc_b, vr_b,
    *, P, C, KB, gamma, n_sweeps, barrier,
):
    # Flat offsets: cell rows are (k, c, d, cell); the carried row is
    # (c, d, cell).
    SD, SC = P, 4 * P
    SK = C * SC
    f32 = jnp.float32
    cell = jnp.arange(P, dtype=jnp.int32)
    krow = jnp.arange(KB, dtype=jnp.int32)[:, None]
    n_chunks = P // KB

    def sync():
        if barrier:
            plgpu.debug_barrier()

    @pl.loop(0, n_chunks * C * 4)
    def _(j):
        chunk = pl.ds(j * KB * P, KB * P)
        plgpu.store(vc_a.at[chunk], jnp.zeros(KB * P, f32))

    plgpu.store(vr_a.at[pl.ds(0, C * 4 * P)], jnp.zeros(C * 4 * P, f32))
    sync()

    def half_sweep(src_c, src_r, dst_c, dst_r):
        for c in range(C):
            for d in range(4):
                fl = plgpu.load(flags_ref.at[pl.ds((d * C + c) * P, P)])
                fr = plgpu.load(front_ref.at[pl.ds(d * P, P)])

                def has(b):
                    return ((fl >> b) & 1) != 0

                fwd_ok = has(_WALK) & ~has(_LAVA)
                closed = has(_CLOSED)
                terminal = has(_GOAL)
                frc = jnp.maximum(fr, 0)
                cd = c * SC + d * SD
                turn_l = c * SC + ((d - 1) % 4) * SD
                turn_r = c * SC + ((d + 1) % 4) * SD
                tog = (fl >> _CFG_SHIFT) * SC + d * SD
                v_car = plgpu.load(src_r.at[cd + cell])

                @pl.loop(0, n_chunks)
                def _(j):
                    k = j * KB + krow  # (KB, 1) key locations
                    row = k * SK
                    vd = plgpu.load(src_c.at[row + cd + cell])
                    vl = plgpu.load(src_c.at[row + turn_l + cell])
                    vr = plgpu.load(src_c.at[row + turn_r + cell])
                    q = jnp.maximum(vd, jnp.maximum(vl, vr))
                    vn = plgpu.load(src_c.at[row + cd + frc])
                    q = jnp.where(fwd_ok & (fr != k), jnp.maximum(q, vn), q)
                    q = jnp.where(fr == k, jnp.maximum(q, v_car), q)
                    vt = plgpu.load(src_c.at[row + tog + cell])
                    q = jnp.where(closed, jnp.maximum(q, vt), q)
                    q = jnp.where(terminal | has(_TARGET), 1.0, gamma * q)
                    plgpu.store(dst_c.at[row + cd + cell], q)

                # Carried-key row: no pickup; drop puts the key on the
                # front cell; toggle may also unlock.
                q = jnp.maximum(v_car, plgpu.load(src_r.at[turn_l + cell]))
                q = jnp.maximum(q, plgpu.load(src_r.at[turn_r + cell]))
                vn = plgpu.load(src_r.at[cd + frc])
                q = jnp.where(fwd_ok, jnp.maximum(q, vn), q)
                vdrop = plgpu.load(src_c.at[frc * SK + cd + cell])
                q = jnp.where(has(_DROP), jnp.maximum(q, vdrop), q)
                vt = plgpu.load(src_r.at[tog + cell])
                q = jnp.where(closed | has(_UNLOCK), jnp.maximum(q, vt), q)
                q = jnp.where(terminal, 1.0, gamma * q)
                plgpu.store(dst_r.at[cd + cell], q)
        sync()

    @pl.loop(0, n_sweeps // 2)
    def _(i):
        half_sweep(vc_a, vr_a, vc_b, vr_b)
        half_sweep(vc_b, vr_b, vc_a, vr_a)

    if n_sweeps % 2:
        half_sweep(vc_a, vr_a, vc_b, vr_b)


@partial(jax.jit, static_argnames=("gamma", "n_sweeps", "interpret"))
def pallas_key_value_iteration(
    layouts: KeyTabularLayout,
    gamma: float = 0.995,
    n_sweeps: int = 256,
    *,
    interpret: bool = False,
):
    """Batched key-domain VI, one kernel program per layout.

    ``layouts`` is a :class:`..tabular_key.KeyTabularLayout` with a leading
    batch axis B.  Returns V with shape (B, K, C, 4, H, W), equal to the V
    of ``vmap(key_value_iteration)``.  The policy, if needed, is one XLA
    argmax backup over this V.  ``interpret=True`` runs the kernel in the
    Pallas interpreter (tests on the CPU)."""
    B, h, w = layouts.base_walk.shape
    HW = h * w
    C = 1 << layouts.door_pos.shape[-2]
    P = _pow2(HW)
    KB = min(P, max(1, BLOCK_ELEMS // P))
    flags, front = jax.vmap(partial(_layout_tables, P=P))(layouts)

    n_cell, n_car = P * C * 4 * P, C * 4 * P
    flat = lambda n: pl.BlockSpec((None, n), lambda b: (b, 0))
    buf = lambda n: jax.ShapeDtypeStruct((B, n), jnp.float32)
    vc_a, vr_a, vc_b, vr_b = pl.pallas_call(
        partial(
            _key_vi_kernel, P=P, C=C, KB=KB, gamma=gamma,
            n_sweeps=n_sweeps, barrier=not interpret,
        ),
        grid=(B,),
        in_specs=[flat(4 * C * P), flat(4 * P)],
        out_specs=[flat(n_cell), flat(n_car), flat(n_cell), flat(n_car)],
        out_shape=[buf(n_cell), buf(n_car), buf(n_cell), buf(n_car)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="key_value_iteration",
    )(flags.reshape(B, -1), front.reshape(B, -1))
    vc, vr = (vc_b, vr_b) if n_sweeps % 2 else (vc_a, vr_a)

    vc = vc.reshape(B, P, C, 4, P)[:, :HW, ..., :HW]
    vr = vr.reshape(B, 1, C, 4, P)[..., :HW]
    return jnp.concatenate([vc, vr], axis=1).reshape(B, HW + 1, C, 4, h, w)
