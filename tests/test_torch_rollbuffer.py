"""The port's rollbuffer against the JAX package's ``state/rollbuffer.py``
over several frames of insert / roll / select / gather with expiry,
capacity overflow and late arrivals: every field bit-equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ros_gpu_depthmap_fusion_tpu.state import rollbuffer as jrb
from ros_gpu_depthmap_fusion_tpu_torch.core import transforms as ttf
from ros_gpu_depthmap_fusion_tpu_torch.state import rollbuffer as trb

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
