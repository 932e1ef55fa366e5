"""A numpy model of the level kernel's compaction prologue
(csrc/linearize.cu ``select_slots``) against the JAX package's
``compact_reference`` and the port's.

On the slab route under a point budget every launch of
csrc/linearize.cu first decides which pixel each of the ``budget`` slots
takes: the C CTAs of a row's cluster each count the selected pixels of
their band of the slab (each warp a sub-band, in chunks of 32 pixels),
exchange the counts (each CTA's offset is the counts of the ranks before
it), rank their selected pixels (the ranks before the CTA, before the
warp, before the chunk, and a warp ballot's lanes below),
map rank q to slot q (count <= budget) or floor(q budget / count) in
64-bit integers, and let only a slot's first pixel write it into the
owning CTA's table (slot j belongs to CTA j // P, P = ceil(budget / C)).
``_select_slots`` below repeats those steps on a selection mask.

What each slot holds is compared exactly (they are pixel indices), and so
is the selected flag of every slot: against the JAX package's
``compact_reference`` (its split int32 slot map, the first-writer
scatter) and the port's plain ``compact_reference`` (the inverted map), on
seeded masks with a selected count of 0, 1, below, at and above the
budget, for clusters of 1, 4, 8 and 16 CTAs, and at a level of 523 264
pixels (the JAX package asserts fewer than 2^19).
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_slam_tpu.ops import linearize as j_lin
from dvo_slam_tpu_torch.ops import linearize as t_lin

SRC = Path(t_lin.__file__).parents[1] / "csrc" / "linearize.cu"
THREADS, WARP = 512, 32  # csrc/linearize.cu kThreads; a warp
WARPS = THREADS // WARP  # kWarps: the sub-bands of a CTA's band
MAX_CLUSTER = 16  # kMaxCluster


def _select_slots(selected, budget, C):
    """The kernel's slot tables for one row: ``(tables, n_fill)``, tables
    (C, P) int64 with each CTA's slot-to-pixel map (-1 where nothing was
    written), n_fill = min(count, budget). Raises if a slot is written
    twice or a filled slot is left empty."""
    plane = selected.shape[0]
    P = -(-budget // C)
    band = -(-plane // C)
    bands = [(min(r * band, plane), min(min(r * band, plane) + band, plane))
             for r in range(C)]
    # Each CTA's count, then every CTA's offset and the row's count.
    counts = np.array([int(selected[lo:hi].sum()) for lo, hi in bands])
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    count = int(counts.sum())
    tables = np.full((C, P), -1, np.int64)
    for (lo, hi), off in zip(bands, offsets):
        # Warp w's sub-band of the CTA's band, in chunks of 32 pixels.
        sub = -(-(hi - lo) // WARPS)
        subs = [(min(lo + w * sub, hi), min(min(lo + w * sub, hi) + sub, hi))
                for w in range(WARPS)]
        warp_counts = [int(selected[a:b].sum()) for a, b in subs]
        warp_before = off + np.concatenate([[0], np.cumsum(warp_counts)[:-1]])
        for (a, b), done in zip(subs, warp_before):
            n_chunks = -(-(b - a) // WARP)
            sel = np.zeros(n_chunks * WARP, bool)
            sel[:b - a] = selected[a:b]
            lanes = sel.reshape(n_chunks, WARP).astype(np.int64)
            # A lane's rank: the ranks before its warp, the chunks before
            # it, and the ballot's lanes below it.
            lane_before = np.cumsum(lanes, axis=1) - lanes
            chunk_counts = lanes.sum(axis=1, keepdims=True)
            chunk_before = np.cumsum(chunk_counts, axis=0) - chunk_counts
            q = (done + chunk_before + lane_before).reshape(-1)
            pix = a + np.arange(n_chunks * WARP)
            q, pix = q[sel], pix[sel]
            if count > budget:
                # slot_of: the quotient and the remainder's first-writer
                # test, which is JAX's floor-difference test.
                slot, rem = np.divmod(q * budget, count)
                first = rem < budget
                assert np.array_equal(
                    first, (q == 0) | ((q - 1) * budget // count != slot))
            else:
                slot, first = q, np.ones_like(q, bool)
            for s, i in zip(slot[first], pix[first]):
                owner = s // P
                assert tables[owner, s - owner * P] == -1, \
                    "a slot written twice"
                tables[owner, s - owner * P] = i
    n_fill = min(count, budget)
    filled = tables.reshape(-1)[:n_fill]
    assert (filled >= 0).all(), "a filled slot without a pixel"
    return tables, n_fill


def _mask(n, count, seed):
    rng = np.random.default_rng(seed)
    mask = np.zeros(n, bool)
    mask[rng.choice(n, count, replace=False)] = True
    return mask


def _slot_pixels(tables, n_fill, budget):
    """The model's pixel of every slot below n_fill, and every slot's
    selected flag."""
    return tables.reshape(-1)[:n_fill], np.arange(budget) < n_fill


def _jax_slots(mask, budget):
    """The JAX package's compact_reference on points whose px is their
    pixel index (exact in f32 below 2^24)."""
    n = mask.shape[0]
    idx = jnp.arange(n, dtype=jnp.float32)
    ref = j_lin.RefData(px=idx, py=idx, pz=idx, i1=idx,
                        selected=jnp.asarray(mask))
    out = j_lin.compact_reference(ref, budget)
    return np.asarray(out.px).astype(np.int64), np.asarray(out.selected)


def _port_slots(mask, budget):
    """The port's plain compact_reference on the same points."""
    n = mask.shape[0]
    idx = torch.arange(n, dtype=torch.float32)
    ref = t_lin.RefData(px=idx, py=idx, pz=idx, i1=idx,
                        selected=torch.from_numpy(mask))
    out = t_lin.compact_reference(ref, budget)
    return out.px.numpy().astype(np.int64), out.selected.numpy()


def _check(mask, budget, C):
    tables, n_fill = _select_slots(mask, budget, C)
    pixels, selected = _slot_pixels(tables, n_fill, budget)
    assert n_fill == min(int(mask.sum()), budget)
    for name, (got_px, got_sel) in (("jax", _jax_slots(mask, budget)),
                                    ("port", _port_slots(mask, budget))):
        np.testing.assert_array_equal(got_sel, selected, err_msg=name)
        np.testing.assert_array_equal(got_px[:n_fill], pixels, err_msg=name)
        # The selected count the kernel writes (its extras, the valid
        # ratio's denominator) is the compacted selection's.
        assert int(got_sel.sum()) == n_fill, name
    return n_fill


# An 80x60 level at budget 0.5 (2 432 slots, compact_budget's 128-slot
# tiles): counts of 0, 1, below, at and above the budget.
N_SMALL = 80 * 60
BUDGET_SMALL = t_lin.compact_budget(N_SMALL, 0.5, 128)
COUNTS = {"none": 0, "one": 1, "below": 1500, "at": BUDGET_SMALL,
          "above": 4000, "all": N_SMALL}


@pytest.mark.parametrize("C", [1, 4, 8, 16])
@pytest.mark.parametrize("case", sorted(COUNTS))
def test_slots_like_compact_reference(case, C):
    count = COUNTS[case]
    mask = _mask(N_SMALL, count, seed=17 + count)
    assert _check(mask, BUDGET_SMALL, C) == min(count, BUDGET_SMALL)


@pytest.mark.parametrize("C", [8, 16])
@pytest.mark.parametrize("frac, count", [(0.5, 400_000), (0.25, 100_000),
                                         (0.1, 523_264)])
def test_slots_near_two_to_the_19(frac, count, C):
    """A 1024x511 level (523 264 pixels, under the JAX package's 2^19
    bound): q * budget reaches 1.4e11, where only the split int32 map or
    64-bit arithmetic stays exact."""
    n = 1024 * 511
    budget = t_lin.compact_budget(n, frac, 128)
    mask = _mask(n, count, seed=count)
    assert _check(mask, budget, C) == min(count, budget)


def test_slots_with_a_budget_past_the_grid():
    """compact_budget rounds up to whole 128-slot tiles, so a budget of 1.0
    at 80x60 has 4 864 slots for 4 800 pixels: every pixel is filled in
    order, the last 64 slots stay unselected."""
    budget = t_lin.compact_budget(N_SMALL, 1.0, 128)
    assert budget == 4864 > N_SMALL
    mask = np.ones(N_SMALL, bool)
    tables, n_fill = _select_slots(mask, budget, t_lin.cluster_size(budget))
    assert n_fill == N_SMALL
    np.testing.assert_array_equal(tables.reshape(-1)[:n_fill],
                                  np.arange(N_SMALL))
    _check(mask, budget, t_lin.cluster_size(budget))


def _slot_of(q, budget, count):
    """csrc/linearize.cu slot_of in Python's IEEE doubles and integers:
    the double quotient corrected by one step of the remainder."""
    num = q * budget
    slot = int(float(num) / float(count))
    rem = num - slot * count
    if rem < 0:
        slot, rem = slot - 1, rem + count
    elif rem >= count:
        slot, rem = slot + 1, rem - count
    return slot, rem < budget


@pytest.mark.parametrize("scale", ["small", "2^19", "2^31"])
def test_slot_of_is_exact(scale):
    """The kernel's slot map is the exact floor(q budget / count), and its
    first-writer test JAX's, for ranks q < count and budgets below count:
    from small levels through the JAX package's 2^19 bound to counts near
    2^31, where q budget nears 2^62 and a double holds it only to 2^9."""
    rng = np.random.default_rng({"small": 1, "2^19": 2, "2^31": 3}[scale])
    top = {"small": 5_000, "2^19": 1 << 19, "2^31": (1 << 31) - 1}[scale]
    for _ in range(4000):
        count = int(rng.integers(2, top + 1))
        budget = int(rng.integers(1, count))
        q = int(rng.choice([0, 1, count - 1, int(rng.integers(0, count))]))
        slot, first = _slot_of(q, budget, count)
        assert slot == q * budget // count, (q, budget, count)
        assert first == (q == 0 or (q - 1) * budget // count != slot)


def _constant(text, name):
    m = re.search(rf"\b{name} = (\d+)", text)
    assert m, name
    return int(m.group(1))


def test_model_in_step_with_the_kernel_source():
    """The model's bands, warp sub-bands, 32-pixel chunks and cluster
    limit are the kernel's, the slot tiles the wrappers' and the JAX
    package's gather tile, and the kernel computes the ranks, the slot map
    and the first-writer test the model computes, in 64-bit integers."""
    text = SRC.read_text()
    assert _constant(text, "kThreads") == THREADS
    assert "constexpr int kWarps = kThreads / 32;" in text
    assert _constant(text, "kMaxCluster") == MAX_CLUSTER == t_lin._MAX_CLUSTER
    assert t_lin._COMPACT_TILE_GATHER == j_lin._COMPACT_TILE_GATHER == 128
    body = text[text.index("__device__ void select_slots("):]
    body = body[:body.index("\n}\n")]
    slot_of = text[text.index("__device__ __forceinline__ int slot_of("):]
    slot_of = slot_of[:slot_of.index("\n}\n")]
    for line in ("const int64_t num = (int64_t)q * budget;",
                 "int64_t slot = (int64_t)((double)num / (double)count);",
                 "int64_t rem = num - slot * count;",
                 "*first = rem < budget;"):
        assert line in slot_of, line
    for line in ("const int slot = count > budget ? slot_of(q, budget, "
                 "count, &first) : q;",
                 "sh.n_fill = min(total, p.budget);",
                 "const int owner = slot / p.P;",
                 "const int64_t band = (plane + C - 1) / C;",
                 "const int sub = (hi - lo + kWarps - 1) / kWarps;",
                 "const int wlo = min(lo + warp * sub, hi), whi = min(wlo "
                 "+ sub, hi);",
                 "for (int c0 = wlo, c = 0; c0 < whi; c0 += 32, ++c) {",
                 "for (int w = 0; w < warp; ++w) done += "
                 "(int)sh.sel_warp[w];",
                 "__popc(bal & ((1u << lane) - 1u))"):
        assert line in body, line
    # The budget the kernel's launch takes is prepare_reference's.
    cfg = t_lin.TrackerConfig(point_budget_fraction=0.25)
    assert t_lin.ref_budget(cfg, 240, 320) == t_lin.compact_budget(
        240 * 320, 0.25, 128) == j_lin.compact_budget(240 * 320, 0.25, 128)
    assert t_lin.ref_budget(t_lin.TrackerConfig(), 240, 320) == 0
    assert math.ceil(t_lin.ref_budget(cfg, 240, 320)
                     / t_lin.cluster_size(19200)) == 2400
