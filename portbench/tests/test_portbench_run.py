"""A whole run of a cell defined in a fixture, on the CPU at a tiny size:
``correct`` holds for the port as it is, and fails for each fault the cells
can have, planted in the timed path underneath the harness."""

import pytest
import torch

from portbench import run

SEED = 2**31 + 77


def _run(tiny):
    return run.run_cell(tiny, "tiny.match", SEED, 0.5, 0, device="cpu")


def test_sound_run_is_correct(tiny):
    result = _run(tiny)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == {"lp_err", "label_mismatch", "conf_err"}
    assert set(result["metrics"]) == {"setup_s", "vod_frames_per_s"}
    assert result["metrics"]["vod_frames_per_s"]["value"] > 0


def test_traced_run(tiny):
    """A traced run on the CPU: the harness's spans, the embed's on the
    port's dispatch thread among them, and no reading of what needs a card
    (a roofline, device time, copies), never a 0 in its place."""
    from portbench import tracing

    result = run.run_cell(tiny, "tiny.match", SEED, 0.5, 1, device="cpu")
    assert result["correct"] and result["attempted"] == 1
    metrics = result["metrics"]
    assert metrics["host_loop_ms_per_chunk"]["value"] > 0
    assert metrics["classify_ms_per_vod"]["value"] > 0
    assert not {"k2_roofline", "k4_roofline", "embed_device_us_per_crop",
                "h2d_bytes_per_frame"} & set(metrics)
    trace = tracing.Trace(f"{run.OUT_DIR}/trace-tiny.match.json")
    assert len(trace.spans["portbench.embed"]) == 2  # 96 frames, chunks of 48
    assert len(trace.spans["portbench.classify"]) == 1


def _plant(tiny, monkeypatch, fault):
    """Break the timed path underneath the harness: the route's set-up,
    then ``fault`` on the route."""
    route_cls = tiny.module("routes", "vod").Route
    setup = route_cls.setup

    def broken(route):
        setup(route)
        fault(route)

    monkeypatch.setattr(route_cls, "setup", broken)


def unchanged_state(route):
    """Every chunk after the first leaves the embedding buffer as it was."""
    scatter = route.pipe.scatter_embeddings
    route.pipe.scatter_embeddings = lambda buf, emb, row: buf if row else scatter(buf, emb, row)


def half_batch(route):
    """Each embed call computes half of its crops and copies them over the
    other half."""
    embed = route.pipe.embed_crops_yuv

    def half(crops):
        emb = embed(crops[:crops.shape[0] // 2])
        return torch.cat([emb, emb])

    route.pipe.embed_crops_yuv = half


def altered_label(route):
    """K3 returns one label changed."""
    k3 = route._pipeline_mod.viterbi_decode

    def altered(log_probs, true_len, switch_cost):
        labels = k3(log_probs, true_len, switch_cost)
        labels[1, int(true_len) // 2] = (labels[1, int(true_len) // 2] + 1) % log_probs.shape[-1]
        return labels

    route._pipeline_mod.viterbi_decode = altered


def altered_confidence(route):
    """classify_buffer returns one confidence changed by half a point."""
    classify = route.pipe.classify_buffer

    def altered(*args, **kwargs):
        labels, conf = classify(*args, **kwargs)
        conf = conf.clone()
        conf[3, 0] += 0.5
        return labels, conf

    route.pipe.classify_buffer = altered


@pytest.mark.parametrize("fault", [unchanged_state, half_batch, altered_label,
                                   altered_confidence], ids=lambda f: f.__name__)
def test_fault_is_not_correct(tiny, monkeypatch, fault):
    _plant(tiny, monkeypatch, fault)
    result = _run(tiny)
    assert not result["correct"], result["checks"]
