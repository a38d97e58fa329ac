"""The port's rollbuffer against the JAX package's ``state/rollbuffer.py``
over several frames of insert / roll / select / gather with expiry,
capacity overflow and late arrivals: every field bit-equal; and the engine
step's lidar stages (``advance_and_gather``) against the JAX engine's
chain of the point-sequence filter and those four calls, in the edge cases
of ``test_torch_cuda.LIDAR_CASES``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ros_gpu_depthmap_fusion_tpu.ops import stencil as jstencil
from ros_gpu_depthmap_fusion_tpu.state import rollbuffer as jrb
from ros_gpu_depthmap_fusion_tpu_torch.core import transforms as ttf
from ros_gpu_depthmap_fusion_tpu_torch.state import rollbuffer as trb
from test_torch_cuda import LIDAR_CASES, check_lidar_refusals, lidar_case

STAGE, SEQS = 48, 4


def _batch(rng, frame, n_seqs, late=False):
    """A staging batch of ``n_seqs`` sequences stamped at ``frame``."""
    pts = np.zeros((STAGE, 4), np.float32)
    mask = np.zeros(STAGE, bool)
    idx = np.zeros(STAGE, np.int32)
    sec = np.zeros(SEQS, np.int32)
    nsec = np.zeros(SEQS, np.int32)
    cnt = np.zeros(SEQS, np.int32)
    tfs = np.tile(np.eye(4, dtype=np.float32), (SEQS, 1, 1))
    off = 0
    for i in range(n_seqs):
        k = int(rng.integers(3, 12))
        pts[off:off + k, :3] = rng.normal(0, 4, (k, 3))
        pts[off:off + k, 3] = 1
        mask[off:off + k] = rng.random(k) < 0.9
        idx[off:off + k] = i
        t = frame * 0.1 - (0.35 if late and i == 0 else 0.0)
        sec[i], nsec[i] = int(t + 10), int(round((t % 1) * 1e9)) % 10 ** 9
        cnt[i] = k
        tfs[i] = ttf.make_se3(ttf.rot_z(rng.uniform(-1, 1)),
                              rng.uniform(-2, 2, 3))
        off += k
    return (pts, mask, idx, sec, nsec, cnt, tfs, np.int32(off),
            np.int32(n_seqs))


def _assert_rb_equal(t, j):
    for f in trb.RollBuffer._fields:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)),
                                      err_msg=f)


@pytest.mark.parametrize("point_cap,seq_cap", [(128, 16), (40, 6)])
def test_rollbuffer_frames_match_jax(point_cap, seq_cap):
    """Eight frames: inserts (late stamps clamped forward), expiry of a
    0.25 s window, selection and gathered world/crop transforms; the small
    capacities force whole-sequence drops."""
    rng = np.random.default_rng(point_cap)
    t_rb = trb.make_rollbuffer(point_cap, seq_cap, "cpu")
    j_rb = jrb.make_rollbuffer(point_cap, seq_cap)
    any_overflow, selected = False, 0
    for frame in range(8):
        b = _batch(rng, frame, int(rng.integers(1, SEQS + 1)),
                   late=frame == 5)
        t_rb, t_ov = trb.insert_sequences(t_rb, *map(torch.as_tensor, b))
        j_rb, j_ov = jrb.insert_sequences(j_rb, *map(jnp.asarray, b))
        assert bool(t_ov) == bool(j_ov)
        any_overflow |= bool(t_ov)
        _assert_rb_equal(t_rb, j_rb)
        now = frame * 0.1 + 10
        lo = now - 0.25
        mn = (np.int32(int(lo)), np.int32(int(round((lo % 1) * 1e9))))
        mx = (np.int32(int(now)), np.int32(int(round((now % 1) * 1e9))))
        t_rb = trb.roll(t_rb, *map(torch.as_tensor, mn))
        j_rb = jrb.roll(j_rb, *map(jnp.asarray, mn))
        _assert_rb_equal(t_rb, j_rb)
        t_sel = trb.select_timespan(t_rb, *map(torch.as_tensor, mn + mx))
        j_sel = jrb.select_timespan(j_rb, *map(jnp.asarray, mn + mx))
        for a, c in zip(t_sel, j_sel):
            assert int(a) == int(c)
        selected += int(t_sel.point_count) > 0
        tfw = ttf.make_se3(ttf.rot_z(0.3 * frame), (1.0, -2.0, 0.5))
        tfc = ttf.make_se3(ttf.rot_x(0.1), (0.0, 0.2, -0.1))
        cap = min(64, point_cap)
        got = trb.gather_selection(t_rb, t_sel, torch.as_tensor(tfw),
                                   torch.as_tensor(tfc), cap)
        ref = jrb.gather_selection(j_rb, j_sel, jnp.asarray(tfw),
                                   jnp.asarray(tfc), cap)
        for a, c in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    assert any_overflow == (point_cap == 40)
    assert selected >= 6


def test_roll_everything_expires():
    rng = np.random.default_rng(1)
    rb, _ = trb.insert_sequences(trb.make_rollbuffer(64, 8, "cpu"),
                                 *map(torch.as_tensor, _batch(rng, 0, 2)))
    rb = trb.roll(rb, 100, 0)
    assert int(rb.num_seqs) == 0 and int(rb.num_points) == 0
    assert not rb.mask.any() and not rb.points.any()


def test_dump_matches_jax():
    """``state/rollbuffer.py:313 dump`` (the reference's inspector): the
    same keys, extents and arrays as the JAX dump after two frames."""
    rng = np.random.default_rng(4)
    t_rb = trb.make_rollbuffer(64, 8, "cpu")
    j_rb = jrb.make_rollbuffer(64, 8)
    for frame in range(2):
        b = _batch(rng, frame, 3)
        t_rb, _ = trb.insert_sequences(t_rb, *map(torch.as_tensor, b))
        j_rb, _ = jrb.insert_sequences(j_rb, *map(jnp.asarray, b))
    got, ref = trb.dump(t_rb), jrb.dump(j_rb)
    assert list(got) == list(ref)
    assert got["num_seqs"] == ref["num_seqs"] == 6 and got["num_points"] > 0
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k


def _jax_lidar_stages(j_rb, kw, size, cap):
    """The JAX engine's stages 1-5 (``pipeline/engine.py:169-191``)."""
    sb = [jnp.asarray(x.numpy()) for x in kw["seq_batch"]]
    points, seq_idx, sec, nsec, cnt, tfs, n_pts, n_seqs = sb
    staged = jnp.arange(points.shape[0], dtype=jnp.int32) < n_pts
    mask = jstencil.filter_point_sequence(
        points, staged, n_pts, size, jnp.asarray(kw["ps_threshold"].numpy()))
    j_rb, _ = jrb.insert_sequences(j_rb, points, mask, seq_idx, sec, nsec,
                                   cnt, tfs, n_pts, n_seqs)
    mn = [jnp.asarray(x.numpy()) for x in kw["roll_min"]]
    mx = [jnp.asarray(x.numpy()) for x in kw["now"]]
    j_rb = jrb.roll(j_rb, *mn)
    sel = jrb.select_timespan(j_rb, *mn, *mx)
    out = jrb.gather_selection(j_rb, sel, jnp.asarray(
        kw["tf_world_move"].numpy()), jnp.asarray(kw["tf_crop_move"].numpy()),
        cap)
    return j_rb, out, sel


@pytest.mark.parametrize("name", list(LIDAR_CASES))
def test_lidar_stages_match_jax(name):
    """``advance_and_gather`` on CPU tensors (its twin) equal, frame by
    frame, to the JAX engine's filter, insert, roll, select and gather:
    the new buffer, the gathered rows and the selection."""
    rb, cap, size, frames = lidar_case(name, "cpu")
    p_cap, s_cap = rb.point_capacity, rb.seq_capacity
    j_rb = jrb.make_rollbuffer(p_cap, s_cap)
    selected = 0
    for f, kw in enumerate(frames):
        rb, got, sel = trb.advance_and_gather(rb, filter_size=size,
                                              capacity=cap, **kw)
        j_rb, ref, j_sel = _jax_lidar_stages(j_rb, kw, size, cap)
        _assert_rb_equal(rb, j_rb)
        for a, c in zip(got, ref[:3]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(c),
                                          err_msg=f"frame {f}")
        assert [int(x) for x in sel] == [int(x) for x in j_sel], f
        assert int(sel.point_count) == int(ref[3])
        selected += int(sel.point_count)
    assert (selected == 0) == (name == "empty")


def test_lidar_stages_cases_reach_their_edges():
    """The cases do what their names say: a clamped stamp, both
    overflows, a buffer emptied by expiry, an empty window over live
    sequences, both capacities exactly full, and filtered points."""
    seen = set()
    for name in LIDAR_CASES:
        rb, cap, size, frames = lidar_case(name, "cpu")
        for kw in frames:
            sb = kw["seq_batch"]
            before = rb
            rb, (_, _, valid), sel = trb.advance_and_gather(
                rb, filter_size=size, capacity=cap, **kw)
            n_new, n_seqs = int(sb.num_points), int(sb.num_seqs)
            live = int(rb.num_seqs)
            if n_seqs and int(before.num_seqs):
                last = (int(before.seq_sec[int(before.num_seqs) - 1]),
                        int(before.seq_nsec[int(before.num_seqs) - 1]))
                if (int(sb.seq_sec[0]), int(sb.seq_nsec[0])) < last:
                    seen.add("late_stamp")
            if int(before.num_seqs) + n_seqs > rb.seq_capacity:
                seen.add("seq_overflow")
            if int(before.num_points) + n_new > rb.point_capacity:
                seen.add("point_overflow")
            if int(before.num_seqs) and not live:
                seen.add("all_expire")
            if live and not int(sel.seq_count):
                seen.add("empty_window")
            if int(rb.num_points) == rb.point_capacity \
                    and live == rb.seq_capacity:
                seen.add("full")
            if n_new and int(sel.point_count) > int(valid.sum()):
                seen.add("filtered")
    assert seen == {"late_stamp", "seq_overflow", "point_overflow",
                    "all_expire", "empty_window", "full", "filtered"}


def test_lidar_stages_plain_runs_the_twin(monkeypatch):
    """``plain=True`` runs the twin whatever the device (a meta tensor
    here, which has no kernel), launches nothing and counts no kernel
    step; without it a device that is neither CPU nor CUDA raises."""
    from ros_gpu_depthmap_fusion_tpu_torch.utils import profiling
    rb, cap, size, frames = lidar_case("late_stamp", "cpu")
    meta = trb.RollBuffer(*(x.to("meta") for x in rb))
    calls = []
    monkeypatch.setattr(trb, "advance_and_gather_plain",
                        lambda *a: calls.append(a) or "twin")
    n = trb.launches
    profiling.reset()
    profiling.enable()
    try:
        assert trb.advance_and_gather(meta, filter_size=size, capacity=cap,
                                      plain=True, **frames[0]) == "twin"
        assert trb.advance_and_gather(rb, filter_size=size, capacity=cap,
                                      **frames[0]) == "twin"
        counters = profiling.snapshot()["counters"]
    finally:
        profiling.enable(False)
    assert len(calls) == 2 and calls[0][0] is meta and calls[1][0] is rb
    assert trb.launches == n
    assert "fusion.lidar.kernel_steps" not in counters
    with pytest.raises(ValueError, match="unsupported device"):
        trb.advance_and_gather(meta, filter_size=size, capacity=cap,
                               **frames[0])


def test_lidar_stages_cuda_refuses_bad_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    check_lidar_refusals(torch.device("cuda"))
