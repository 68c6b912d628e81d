"""The QuadConv kernel's split plan (``ops._split_plan``), on the CPU.

The plan fixes how the contraction's reduction over i is cut into chunks
and the ring that streams G, from (I, J, O, C) and the card's SM count.
Pure Python: no JAX, no card.  For every shape the port runs (training's
four blocks at B = 4, a mesh rank's at B = 2, serving's two at B = 8) and
a few ragged ones, the chunks cover [0, I) exactly once, the shared memory
fits a Hopper block, a block's run of ring stages cuts an item once at
most, the wrapper's plan is the same for every batch size
(a row's bits must not depend on the batch it rides in), and at the
path's shapes every one of an H100's 132 SMs gets a work item.
"""

import pytest


def setup_module():
    """Import torch and the port when this file's tests start (every
    xdist worker collects every test file)."""
    global qops
    from repro_torch.kernels.quadconv import ops as qops


# (I, J, O, C): training encoder 0, encoder 1 / decoder 0, decoder 1;
# serving blocks 0 and 1
PATH_SHAPES = [(2048, 2048, 16, 4), (512, 512, 16, 16), (2048, 2048, 16, 16),
               (4096, 4096, 16, 4), (1024, 1024, 16, 16)]
RAGGED_SHAPES = [(1000, 64, 16, 16), (530, 3, 16, 4), (70, 5, 16, 16),
                 (40, 10, 16, 4), (16, 9, 2, 8), (64, 7, 8, 128),
                 (100, 3, 1, 4), (0, 4, 16, 4)]
H100_SMS = 132


@pytest.mark.parametrize("n_sm", [H100_SMS, 78])
@pytest.mark.parametrize("I,J,O,C", PATH_SHAPES + RAGGED_SHAPES)
def test_split_plan_covers_i_once(I, J, O, C, n_sm):
    plan = qops._split_plan(I, J, O, C, n_sm)
    chunks = plan.chunks()
    assert len(chunks) == plan.splits >= 1
    assert chunks[0][0] == 0 and chunks[-1][1] == I
    for (a0, a1), (b0, _) in zip(chunks, chunks[1:]):
        assert a1 == b0 and a0 < a1
    # whole ring stages, the staged f within its room, the block's
    # shared memory within Hopper's 227 KB, a ring of at least 4 stages
    assert plan.rows * O * C == 1024 and plan.chunk % plan.rows == 0
    assert plan.chunk * C <= max(qops._FW_FLOATS, plan.rows * C)
    assert 4 <= plan.stages <= 8
    assert qops._smem_bytes(O, C, plan.chunk, plan.stages) <= 232_448
    assert plan.tiles == -(-J // 4)
    # a block's run is at least one item long: it cuts an item once at most
    assert 1 <= plan.grid <= n_sm
    assert plan.units // plan.grid >= plan.chunk // plan.rows


@pytest.mark.parametrize("I,J,O,C", PATH_SHAPES + RAGGED_SHAPES)
def test_split_plan_does_not_depend_on_batch(I, J, O, C):
    plans = {qops._plan((B, I, C), (J, I, O, C), H100_SMS)
             for B in (1, 2, 4, 8, 11)}
    assert len(plans) == 1


@pytest.mark.parametrize("I,J,O,C", PATH_SHAPES)
def test_split_plan_fills_the_sms(I, J, O, C):
    plan = qops._split_plan(I, J, O, C, H100_SMS)
    assert plan.items >= H100_SMS and plan.grid == H100_SMS
    assert plan.balance(H100_SMS) >= 0.99


def test_split_plan_splits_i_where_j_alone_would_not_fill():
    """At J = 512 with O = C = 16, tiles of j alone are 128 items for 132
    SMs: the plan splits i in two.  Serving block 0's chunks are bound by
    the room for their staged f (1,024 rows at C = 4, so 4 chunks); i of
    one ring stage stays whole."""
    assert qops._split_plan(512, 512, 16, 16, H100_SMS).splits == 2
    assert qops._split_plan(4096, 4096, 16, 4, H100_SMS).splits == 4
    assert qops._split_plan(16, 9, 2, 8, H100_SMS).splits == 1
