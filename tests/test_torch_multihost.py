"""parallel/multihost.py and the sharded render of parallel/sharding.py in
one process, against the JAX package's: the sample and row ranges, init
without a coordinator, and render_multihost (both modes) and
render_sharded at 8x8, depth 2.

Tolerance of the images: test_torch_path.py's pixel rule (>= 99% of the
pixels within rtol 1e-3 + atol 1e-4, means within 0.5%): XLA on the CPU
contracts FMAs and has its own transcendentals."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from gnxraytracer_tpu.models.integrators import path as J_path
from gnxraytracer_tpu.ops import samplers as J_smp
from gnxraytracer_tpu.parallel import multihost as J_mh
from gnxraytracer_tpu.parallel import sharding as J_sh
from gnxraytracer_tpu_torch.models.integrators import path as T_path
from gnxraytracer_tpu_torch.ops import samplers as T_smp
from gnxraytracer_tpu_torch.parallel import multihost as T_mh
from gnxraytracer_tpu_torch.parallel import sharding as T_sh

from test_torch_convert import scene_pair

GRID = [(total, n) for total in (1, 2, 4, 7, 37, 100, 256, 500)
        for n in (1, 2, 3, 4, 8)]


@pytest.mark.parametrize("total,n", GRID)
def test_ranges_are_the_jax_ranges(total, n):
    for pid in range(n):
        assert T_mh.sample_range_for_host(total, pid, n) == \
            J_mh.sample_range_for_host(total, pid, n)
        assert T_mh.row_range_for_host(total, pid, n) == \
            J_mh.row_range_for_host(total, pid, n)
    covered = []
    for pid in range(n):
        start, count = T_mh.sample_range_for_host(total, pid, n)
        covered.extend(range(start, start + max(count, 0)))
    assert covered == list(range(total))


def test_init_is_a_no_op_in_one_process(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    T_mh.init()
    T_mh.init(device="cpu")  # idempotent, and needs no card
    assert not dist.is_initialized()
    assert T_mh.sample_range_for_host(16) == (0, 16)
    assert T_mh.row_range_for_host(9) == (0, 9)
    assert T_sh.make_mesh() == T_sh.make_mesh(1) == T_sh.Mesh(rank=0, size=1)


def test_make_mesh_raises_when_asked_for_more_ranks_than_exist():
    import jax

    n = len(jax.devices())
    with pytest.raises(ValueError, match="devices"):
        J_sh.make_mesh(n + 1)
    with pytest.raises(ValueError, match="only 1 rank"):
        T_sh.make_mesh(2)


def test_backend_choice():
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    assert T_mh.choose_backend(cpu, 1) == T_mh.choose_backend(cpu, 4) == "gloo"
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        assert T_mh.choose_backend(cuda, n) == "nccl"
        assert T_mh.choose_backend(cuda, n + 1) == "gloo"


@pytest.fixture
def fake_cards(monkeypatch):
    """A host with n cards and a process group that only records how it was
    started: the device and backend choice of init, without a card or a
    peer.  Returns (set the card count, the calls)."""
    calls = []
    monkeypatch.setattr(T_mh, "resolve_device", lambda d: torch.device(d))
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.append(("set_device", d)))
    monkeypatch.setattr(T_mh.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)

    def cards(n):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    return cards, calls


# (cards a host, local rank, ranks on the host) -> (device index, backend)
HOST_PLACES = [
    ((1, 0, 1), (0, "nccl")),   # one process a host, one card: two hosts
    ((4, 3, 4), (3, "nccl")),   # four ranks, four cards
    ((1, 1, 2), (0, "gloo")),   # two ranks on one card
    ((2, 3, 4), (1, "gloo")),   # more ranks than cards
]


@pytest.mark.parametrize("place,want", HOST_PLACES)
def test_init_with_a_coordinator_takes_the_rank_place_on_its_host(
        fake_cards, place, want):
    """The coordinator path (one process a host, as in the JAX package)
    takes the rank's device and the backend from its place on its host,
    given as arguments or by LOCAL_RANK / LOCAL_WORLD_SIZE."""
    cards, calls = fake_cards
    n_cards, local_rank, local_ranks = place
    cards(n_cards)
    dev = torch.device("cuda", want[0])
    assert T_mh.rank_device(None, local_rank) == dev
    assert T_mh.choose_backend(dev, local_ranks) == want[1]
    T_mh.init("10.0.0.1:29500", num_processes=8, process_id=5,
              local_rank=local_rank, local_world_size=local_ranks)
    assert calls[0] == ("set_device", dev)
    backend, kw = calls[1]
    assert backend == want[1]
    assert (kw["init_method"], kw["world_size"], kw["rank"]) == (
        "tcp://10.0.0.1:29500", 8, 5)


def test_init_refuses_an_unknown_place_on_the_host(fake_cards, monkeypatch):
    """Without local_rank and local_world_size (arguments or environment)
    init raises before it starts a process group: it does not guess that
    the whole world shares one host."""
    cards, calls = fake_cards
    cards(1)
    with pytest.raises(ValueError, match="place on its host"):
        T_mh.init("10.0.0.1:29500", num_processes=2, process_id=1)
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(ValueError, match="place on its host"):
        T_mh.init("10.0.0.1:29500", num_processes=2, process_id=1)
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(ValueError, match="place on its host"):
        T_mh.init()
    assert calls == []
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    T_mh.init()
    assert calls[1][0] == "nccl" and calls[1][1]["init_method"] == "env://"
    assert calls[1][1]["world_size"] == 2 and calls[1][1]["rank"] == 1


def assert_pixel_rule(a, b):
    assert a.shape == b.shape and np.isfinite(a).all()
    ok = (np.abs(a - b) <= 1e-4 + 1e-3 * np.abs(b)).all(axis=-1)
    assert ok.mean() >= 0.99, f"{(~ok).sum()} of {ok.size} pixels differ"
    assert abs(a.mean() / b.mean() - 1.0) < 0.005


@pytest.fixture(scope="module")
def cornell():
    """The JAX multihost test's configuration: Cornell 8x8, 4 spp, depth 2,
    the faithful estimator, Sobol'."""
    js, jc, ts, tc = scene_pair("cornell", 8, 8)
    kw = dict(spp=4, max_depth=2, spp_chunk=2)
    jcfg = J_path.make_config(js, 8, 8, use_pallas=False, **kw)
    tcfg = T_path.make_config(ts, 8, 8, **kw)
    return dict(js=js, jc=jc, jcfg=jcfg, jsmp=J_smp.make_sobol_sampler(4),
                ts=ts, tc=tc, tcfg=tcfg,
                tsmp=T_smp.make_sobol_sampler(4, device="cpu"))


def test_render_multihost_samples_matches_jax(cornell):
    c = cornell
    jpart, jw = J_mh.render_multihost(c["js"], c["jc"], c["jsmp"], c["jcfg"],
                                      mode="samples")
    tpart, tw = T_mh.render_multihost(c["ts"], c["tc"], c["tsmp"], c["tcfg"],
                                      mode="samples")
    assert tw == jw == 4 and tuple(tpart.shape) == (8, 8, 3)
    ours = T_mh.combine_partials(tpart, tw, c["tcfg"].spp)
    theirs = J_mh.combine_partials(jpart, jw, c["jcfg"].spp)
    assert_pixel_rule(ours.numpy(), np.asarray(theirs))
    # one process: the sample split is the whole render
    full = T_path.render(c["ts"], c["tc"], c["tsmp"], c["tcfg"])
    np.testing.assert_allclose(ours.numpy(), full.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_render_multihost_rows_matches_jax(cornell):
    c = cornell
    jslab, jrows = J_mh.render_multihost(c["js"], c["jc"], c["jsmp"],
                                         c["jcfg"], mode="rows")
    tslab, trows = T_mh.render_multihost(c["ts"], c["tc"], c["tsmp"],
                                         c["tcfg"], mode="rows")
    assert trows == jrows == 8
    assert_pixel_rule(tslab.numpy(), np.asarray(jslab))
    film = T_mh.combine_slabs(tslab, c["tcfg"])
    np.testing.assert_array_equal(film.numpy(), tslab.numpy())
    with pytest.raises(ValueError, match="mode"):
        T_mh.render_multihost(c["ts"], c["tc"], c["tsmp"], c["tcfg"],
                              mode="tiles")


def test_render_sharded_matches_jax(cornell):
    """One rank: render_sharded is path.render's image (box filter, no
    texture, so no ray differentials either way) and the JAX
    render_sharded's on a one-device mesh."""
    c = cornell
    theirs = J_sh.render_sharded(c["js"], c["jc"], c["jsmp"], c["jcfg"],
                                 J_sh.make_mesh(1))
    ours = T_sh.render_sharded(c["ts"], c["tc"], c["tsmp"], c["tcfg"],
                               T_sh.make_mesh())
    assert_pixel_rule(ours.numpy(), np.asarray(theirs))
    full = T_path.render(c["ts"], c["tc"], c["tsmp"], c["tcfg"])
    np.testing.assert_allclose(ours.numpy(), full.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_compaction_report_names_the_stages_a_rank_drops():
    """1,024 lanes keep a stage of 512 slots; a rank's 512 lanes keep it (256
    slots) at half the slots, and a stage of 1/4 is dropped there (128 <
    256)."""
    cfg = T_path.RenderCfg(16, 16, 4, max_depth=5, spp_chunk=4,
                           compact_tail=True, compact_stages=((1, 2), (3, 4)))
    rep = T_mh.compaction_report(cfg, 512)
    assert rep["lanes_one_process"] == 1024
    assert rep["stages_one_process"] == [[1, 2], [3, 4]]
    assert rep["stages_this_rank"] == [[1, 2]]
    assert T_mh.compaction_report(cfg._replace(compact_tail=False), 512)[
        "stages_one_process"] == []


def test_recording_prethin_sees_every_compaction():
    scene, cam = scene_pair("cornell", 16, 16)[2:]
    cfg = T_path.make_config(scene, 16, 16, spp=4, spp_chunk=4, max_depth=5,
                             fast_mis=True, compact_tail=True,
                             compact_stages=((2, 2), (4, 4)))
    smp = T_smp.make_sobol_sampler(4, device="cpu")
    with T_path.recording_prethin() as log:
        T_path.render_chunk(scene, cam, smp, cfg, 0, 4)
    assert [(n, m) for n, m, _ in log] == [(1024, 512), (512, 256)]
    assert all(0.0 < p <= 1.0 for _, _, p in log)
    assert T_path._prethin_log is None  # off again after the block
