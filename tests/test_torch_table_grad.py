"""ops/table.gather_rows and the backward kernel's plain version
(kernels/table_grad.py) on the CPU.

gather_rows takes the hand-written backward only for a table on the card,
so these tests route CPU tables through it by patching ``_on_card``; the
backward then runs ``table_grad_reference``, the version the kernel is held
against on the card (chip_smoke.py phase 10, and the ``cuda`` test below).
Gradients must equal those of plain indexing bit for bit (int32 views).
CPU index-put runs in lane order on one thread, so every test here sets
``torch.set_num_threads(1)``.
"""

import numpy as np
import pytest
import torch

from gnxraytracer_tpu_torch.kernels import table_grad as tg
from gnxraytracer_tpu_torch.ops import table as table_ops
from gnxraytracer_tpu_torch.utils import stats


@pytest.fixture(autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def on_card(monkeypatch):
    """Route CPU tables as gather_rows routes tables on the card."""
    monkeypatch.setattr(table_ops, "_on_card", lambda table: True)


def bits(t):
    return t.detach().contiguous().view(torch.int32).numpy()


def wide_values(rng, shape):
    """float32 values over 40 binary orders of magnitude, both signs, so
    that summing them in another order changes the bits."""
    mag = np.exp2(rng.integers(-20, 20, size=shape)).astype(np.float32)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            * mag)


def case_inputs(name, rng):
    """(table, idx, upstream gradient) of one case."""
    n = 5000
    if name == "rows3_int64":
        table, idx = torch.rand(5, 3), rng.integers(0, 5, n)
    elif name == "rows1_int32":
        table, idx = torch.rand(7), rng.integers(0, 7, n)
    elif name == "empty_rows":  # rows 1 and 4 of 6 get no lane
        table, idx = torch.rand(6, 3), rng.choice([0, 2, 3, 5], n)
    elif name == "one_row_all_lanes":
        table, idx = torch.rand(4, 3), np.full(n, 2)
    elif name == "max_rows":
        table, idx = torch.rand(tg.MAX_ROWS, 2), rng.integers(
            0, tg.MAX_ROWS, 4 * n)
    else:
        raise ValueError(name)
    idx = torch.from_numpy(idx).to(
        torch.int32 if name == "rows1_int32" else torch.int64)
    g = wide_values(rng, (idx.shape[0],) + tuple(table.shape[1:]))
    if name in ("rows3_int64", "empty_rows", "one_row_all_lanes"):
        # all-zero gradient rows, some of them -0.0, and a -0.0 entry in an
        # otherwise nonzero row
        zero = rng.random(idx.shape[0]) < 0.4
        g[torch.from_numpy(zero)] = 0.0
        g[torch.from_numpy(zero & (rng.random(idx.shape[0]) < 0.5))] = -0.0
        g[7, 1] = -0.0
    return table, idx, g


CASES = ["rows3_int64", "rows1_int32", "empty_rows", "one_row_all_lanes",
         "max_rows"]


def grad_through(gather, table, idx, g):
    leaf = table.clone().requires_grad_(True)
    out = gather(leaf, idx)
    out.backward(g)
    return out, leaf.grad


@pytest.mark.parametrize("name", CASES)
def test_gradient_equals_plain_indexing(name, on_card):
    """The gradient through gather_rows's kernel route is plain indexing's,
    bit for bit; the output is the same gather."""
    table, idx, g = case_inputs(name, np.random.default_rng(CASES.index(name)))
    out, got = grad_through(table_ops.gather_rows, table, idx, g)
    assert type(out.grad_fn).__name__ == "_GatherRowsBackward"
    ref_out, want = grad_through(lambda t, i: t[i.long()], table, idx, g)
    np.testing.assert_array_equal(bits(out), bits(ref_out))
    np.testing.assert_array_equal(bits(got), bits(want))
    if name == "empty_rows":
        assert bits(got)[[1, 4]].tolist() == [[0, 0, 0]] * 2  # +0, not -0


def test_gathers_of_one_leaf_add_up_as_plain_indexing(on_card):
    """Three gathers of one leaf, one node each: the leaf's gradient adds
    their sums in the order plain indexing's nodes do."""
    rng = np.random.default_rng(11)
    table = torch.rand(5, 3)
    idxs = [torch.from_numpy(rng.integers(0, 5, 3000)) for _ in range(3)]
    gs = [wide_values(rng, (3000, 3)) for _ in range(3)]

    def run(gather):
        leaf = table.clone().requires_grad_(True)
        loss = sum((gather(leaf, i) * g).sum() for i, g in zip(idxs, gs))
        loss.backward()
        return leaf.grad

    np.testing.assert_array_equal(
        bits(run(table_ops.gather_rows)), bits(run(lambda t, i: t[i])))


def test_table_over_max_rows_keeps_pytorchs_backward(on_card):
    rng = np.random.default_rng(3)
    table = torch.rand(tg.MAX_ROWS + 1, 3)
    idx = torch.from_numpy(rng.integers(0, tg.MAX_ROWS + 1, 4000))
    g = wide_values(rng, (4000, 3))
    out, got = grad_through(table_ops.gather_rows, table, idx, g)
    assert type(out.grad_fn).__name__ == "IndexBackward0"
    _, want = grad_through(lambda t, i: t[i], table, idx, g)
    np.testing.assert_array_equal(bits(got), bits(want))


def test_no_function_without_a_gradient_on_the_card(on_card):
    """A render (no grad mode), a table that requires no grad, an int
    table and a float64 one take the plain gather."""
    idx = torch.tensor([0, 2, 1, 2], dtype=torch.int32)
    leaf = torch.rand(3, 3, requires_grad=True)
    with torch.no_grad():
        assert table_ops.gather_rows(leaf, idx).grad_fn is None
    assert table_ops.gather_rows(torch.rand(3, 3), idx).grad_fn is None
    assert table_ops.gather_rows(torch.arange(3), idx).grad_fn is None
    f64 = torch.rand(3, dtype=torch.float64, requires_grad=True)
    assert (type(table_ops.gather_rows(f64, idx).grad_fn).__name__
            == "IndexBackward0")


def test_cpu_tables_take_the_plain_gather():
    """Without the patch a CPU table that requires grad is plainly
    indexed: the hand-written backward is for the card."""
    leaf = torch.rand(3, 3, requires_grad=True)
    out = table_ops.gather_rows(leaf, torch.tensor([0, 1, 1]))
    assert type(out.grad_fn).__name__ == "IndexBackward0"


def test_counters_count_each_route(on_card):
    idx = torch.tensor([0, 1, 1, 0])
    small = torch.rand(2, 3, requires_grad=True)
    large = torch.rand(tg.MAX_ROWS + 1, 3, requires_grad=True)
    with stats.recording() as rec:
        table_ops.gather_rows(small, idx).sum().backward()
        table_ops.gather_rows(small, idx).sum().backward()
        table_ops.gather_rows(large, idx).sum().backward()
        with torch.no_grad():
            table_ops.gather_rows(small, idx)
    assert rec.counters == {"table_grad.kernel": 2, "table_grad.library": 1}
    # nothing is counted without a recording
    table_ops.gather_rows(small, idx).sum().backward()
    assert rec.counters == {"table_grad.kernel": 2, "table_grad.library": 1}


def lane_order_chain(idx, g, rows):
    """The order the kernel keeps for C >= 2: out[r, c] = ((+0 + g[l1, c])
    + g[l2, c]) + ... over the lanes l1 < l2 < ... of row r, in float32."""
    out = np.zeros((rows, g.shape[1]), dtype=np.float32)
    for l, r in enumerate(idx):
        out[r] = out[r] + g[l]
    return out


def test_reference_is_the_lane_order_chain_and_zero_lanes_drop_out():
    """table_grad_reference is the chain in lane order, and leaving out the
    lanes whose gradient row is all +-0 (as the kernel's partition does)
    gives the same bits."""
    rng = np.random.default_rng(5)
    idx = rng.integers(0, 4, 2000)
    g = wide_values(rng, (2000, 3)).numpy()
    zero = rng.random(2000) < 0.4
    g[zero] = np.where(rng.random((int(zero.sum()), 1)) < 0.5, 0.0, -0.0)
    ref = tg.table_grad_reference(torch.from_numpy(idx), torch.from_numpy(g),
                                  4).numpy()
    chain = lane_order_chain(idx, g, 4)
    kept = lane_order_chain(idx[~zero], g[~zero], 4)
    np.testing.assert_array_equal(ref.view(np.int32), chain.view(np.int32))
    np.testing.assert_array_equal(kept.view(np.int32), chain.view(np.int32))


def test_table_grad_checks_its_arguments():
    idx = torch.tensor([0, 1], dtype=torch.int32)
    g = torch.ones(2, 3)
    with pytest.raises(ValueError):
        tg.table_grad(idx, g, tg.MAX_ROWS + 1)
    with pytest.raises(ValueError):
        tg.table_grad(idx, torch.ones(3, 3), 2)
    with pytest.raises(TypeError):
        tg.table_grad(idx.float(), g, 2)
    with pytest.raises(ValueError):
        tg.table_grad(idx, g.double(), 2)


@pytest.mark.parametrize("name", CASES)
def test_partition_groups_each_rows_lanes_in_lane_order(name):
    """The kernel's input: each row's segment holds exactly that row's
    lanes (for C >= 2 those with a nonzero gradient row), in lane order;
    negative indices wrap."""
    table, idx, g = case_inputs(name, np.random.default_rng(CASES.index(name)))
    rows = table.shape[0]
    g = g.reshape(idx.shape[0], -1)
    idx = torch.where(torch.arange(idx.shape[0]) % 7 == 3, idx - rows, idx)
    ordered, keys = tg.partition(idx, g, rows)
    assert ordered.shape == (g.shape[1], idx.shape[0]) and ordered.is_contiguous()
    assert keys.dtype == torch.int32 and keys.shape == idx.shape
    assert bool((keys[1:] >= keys[:-1]).all())
    row = torch.remainder(idx.long(), rows).numpy()
    keep = np.ones(idx.shape[0], bool) if g.shape[1] == 1 else (
        (g != 0).any(dim=1).numpy())
    for r in range(rows):
        lanes = np.flatnonzero((row == r) & keep)
        np.testing.assert_array_equal(
            bits(ordered[:, keys == r].t()), bits(g[lanes]))
    assert int((keys < rows).sum()) == int(keep.sum())


def test_partitioned_chain_equals_the_reference():
    """Each row's segment of the partition, chained from +0 in order (the
    kernel's order for C >= 2), gives index-put's bits, zero lanes left
    out."""
    rng = np.random.default_rng(8)
    table, idx, g = case_inputs("empty_rows", rng)
    rows = table.shape[0]
    ordered, keys = tg.partition(idx, g, rows)
    got = np.zeros((rows, 3), dtype=np.float32)
    for r in range(rows):
        for col in range(3):
            seg = ordered[col, keys == r].numpy()
            got[r, col] = np.add.accumulate(
                np.concatenate([np.zeros(1, np.float32), seg]))[-1]
    want = tg.table_grad_reference(idx, g, rows).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("integrator", ["path", "volpath"])
def test_train_step_gradients_unchanged(integrator, on_card, monkeypatch):
    """A train step on a small Cornell box (the homogeneous-medium one for
    volpath) with every parameter class: the gradients through the kernel
    route equal those of plain indexing bit for bit."""
    from gnxraytracer_tpu_torch.models.integrators import path, volpath
    from gnxraytracer_tpu_torch.ops import samplers
    from gnxraytracer_tpu_torch.parallel import sharding
    from gnxraytracer_tpu_torch.scene import presets

    w = h = 8
    mod = path if integrator == "path" else volpath
    make = (presets.cornell_box if integrator == "path"
            else presets.cornell_homogeneous)
    scene, cam = make(w, h, device="cpu")
    cfg = mod.make_config(scene, w, h, spp=4, max_depth=3, spp_chunk=4)
    smp = samplers.make_halton_sampler(4, w, h, device="cpu")
    target = torch.full((h, w, 3), 0.25)
    params = sharding.extract_params(scene)
    params["kd"] = params["kd"] * 0.8
    step = sharding.make_train_step(cfg, device="cpu", integrator=integrator)

    def grads():
        st = {}
        with stats.recording() as rec:
            step(params, scene, cam, smp, target, lr=1.0, stats=st)
        return st["grads"], rec.counters

    got, counters = grads()
    assert counters.get("table_grad.kernel", 0) > 0
    assert "table_grad.library" not in counters
    monkeypatch.setattr(table_ops, "_on_card", lambda table: False)
    want, counters = grads()
    assert "table_grad.kernel" not in counters
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(bits(got[k]), bits(want[k]), err_msg=k)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no "
                    "CPU mode (chip_smoke.py holds it against its plain "
                    "version on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_reference_on_card(name, cuda_device):
    """The kernel against PyTorch's index-put on the card, bit for bit;
    every call is one counted launch."""
    table, idx, g = case_inputs(name, np.random.default_rng(CASES.index(name)))
    idx, g = idx.to(cuda_device), g.reshape(idx.shape[0], -1).to(cuda_device)
    before = tg.launch_count
    got = tg.table_grad(idx, g, table.shape[0])
    torch.cuda.synchronize()
    assert tg.launch_count == before + 1
    want = tg.table_grad_reference(idx, g, table.shape[0])
    np.testing.assert_array_equal(bits(got.cpu()), bits(want.cpu()))
