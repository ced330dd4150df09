"""The port's tracker (stereovision_tpu_torch/models/bayesian.py, a copy of
the JAX package's NumPy tracker) held against the JAX package's over
seeded detection sequences: predictions, state, the slot-0 quirk and the
errors."""

import dataclasses

import numpy as np
import pytest

from stereovision_tpu.models import bayesian as jbayes

from stereovision_tpu_torch.models import bayesian

from torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)


def _sequence(seed, frames=30):
    """Per frame a list of (x, y, w, h, conf): a few objects moving at
    constant speed with jitter, entering and leaving; some frames with
    more objects than the pool's MAX_OBJECTS, some with none, and far
    jumps past the distance threshold."""
    rng = np.random.default_rng(seed)
    n = 14
    start = rng.integers(0, 1000, (n, 2))
    speed = rng.integers(-30, 31, (n, 2))
    alive = [(int(a), int(a) + int(b)) for a, b in zip(
        rng.integers(0, frames, n), rng.integers(3, frames, n))]
    seq = []
    for t in range(frames):
        dets = []
        for k in range(n):
            if not alive[k][0] <= t < alive[k][1] or rng.random() < 0.1:
                continue
            x, y = start[k] + speed[k] * t + rng.integers(-3, 4, 2)
            if rng.random() < 0.05:
                x += 400
            dets.append((int(x), int(y), int(rng.integers(5, 80)),
                         int(rng.integers(5, 80)), float(rng.random())))
        if t % 11 == 7:
            dets = []
        seq.append(dets)
    return seq


def _state(tr):
    return (tr.x.tolist(), tr.y.tolist(), tr.used.tolist(),
            tr.pred_x.tolist(), tr.pred_y.tolist(), tr.top, tr.queue_empty,
            tr.queue_full, tr.error_list, tr.mean_errors, tr.max_err)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tracker_matches_jax_over_a_sequence(seed):
    port, ref = bayesian.BayesianTracker(), jbayes.BayesianTracker()
    n_preds = 0
    for dets in _sequence(seed):
        pp, pr = port.get_predicted_boxes(), ref.get_predicted_boxes()
        assert [dataclasses.astuple(d) for d in pp] == [
            dataclasses.astuple(d) for d in pr]
        n_preds += sum(d.x != 0 for d in pp)
        port.append([bayesian.Detection(name="car", x=x, y=y, w=w, h=h,
                                        conf=c) for x, y, w, h, c in dets])
        ref.append([jbayes.Detection(name="car", x=x, y=y, w=w, h=h,
                                     conf=c) for x, y, w, h, c in dets])
        assert _state(port) == _state(ref)
    assert n_preds > 0
    assert port.mean_error == ref.mean_error > 0
    assert port.max_err == ref.max_err


def test_unmatched_detections_land_in_slot_0():
    """The reference's unused_id returns 0 in every branch
    (bayesian.cpp:19-25): a detection that matches no track overwrites
    slot 0, in both packages."""
    for mod in (bayesian, jbayes):
        tr = mod.BayesianTracker()
        tr.append([mod.Detection(x=10, y=10), mod.Detection(x=500, y=500)])
        tr.append([mod.Detection(x=900, y=50)])      # far from both tracks
        assert tr.used[0, 1] and not tr.used[1, 1]
        assert (tr.x[0, 1], tr.y[0, 1]) == (900, 50)
        tr.append([mod.Detection(x=905, y=52), mod.Detection(x=12, y=11)])
        assert tr.used[0, 2] and (tr.x[0, 2], tr.y[0, 2]) == (12, 11)


def test_more_detections_than_slots_on_the_first_frame():
    many = [(i * 7, i * 3) for i in range(bayesian.MAX_OBJECTS + 4)]
    port, ref = bayesian.BayesianTracker(), jbayes.BayesianTracker()
    port.append([bayesian.Detection(x=x, y=y) for x, y in many])
    ref.append([jbayes.Detection(x=x, y=y) for x, y in many])
    assert _state(port) == _state(ref)
    assert port.used[:, 0].all()


def test_detection_fields_match_jax():
    assert [(f.name, f.type, f.default) for f in dataclasses.fields(
        bayesian.Detection)] == [(f.name, f.type, f.default)
                                 for f in dataclasses.fields(jbayes.Detection)]
    assert (bayesian.MAX_OBJECTS, bayesian.HISTORY,
            bayesian.DISTANCE_THRESH) == (jbayes.MAX_OBJECTS, jbayes.HISTORY,
                                          jbayes.DISTANCE_THRESH)
