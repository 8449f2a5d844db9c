"""The temporal head's span ``playaid.head`` (``infer/pipeline.py``
``_head_apply``) on the CPU, for each family: one ``classify_buffer`` under
``profiling.recording()`` gives exactly one, a child of
``playaid.classify`` on the same thread, counting the windows of the padded
buffer (both fighters' rows), and recording changes no label or confidence.

Seeded weights (``init``); a buffer of 40 frames pads to 64 rows a fighter.
"""

import pytest
import torch

from playaid_core_torch import profiling
from playaid_core_torch.infer.pipeline import FAMILIES, BatchedActionPipeline

torch.set_num_threads(2)

TRUE_LEN = 40


@pytest.fixture(scope="module", params=FAMILIES)
def pipe_and_buffer(request):
    pipe = BatchedActionPipeline(family=request.param, device="cpu").init(3)
    buf = pipe.make_embedding_buffer(TRUE_LEN)
    gen = torch.Generator().manual_seed(4)
    buf[:2 * TRUE_LEN] = torch.randn(2 * TRUE_LEN, pipe.embed_dim, generator=gen)
    return pipe, buf


@pytest.mark.parametrize("decode", ["argmax", "viterbi"])
def test_one_head_span_a_classify(pipe_and_buffer, decode):
    pipe, buf = pipe_and_buffer
    assert buf.shape[0] == 2 * 64
    kw = dict(decode=decode, switch_cost=16.0)
    labels_off, conf_off = pipe.classify_buffer(buf, TRUE_LEN, **kw)
    with profiling.recording() as rec:
        labels_on, conf_on = pipe.classify_buffer(buf, TRUE_LEN, **kw)
    heads = [s for s in rec.spans if s.name == "playaid.head"]
    classify, = [s for s in rec.spans if s.name == "playaid.classify"]
    assert len(heads) == 1
    head = heads[0]
    assert head.parent == classify.id and head.thread == classify.thread
    assert head.counts == {"windows": buf.shape[0]}
    assert classify.start_ns <= head.start_ns <= head.end_ns <= classify.end_ns
    assert rec.totals() == {"rows": TRUE_LEN, "windows": buf.shape[0]}
    assert torch.equal(labels_on, labels_off) and torch.equal(conf_on, conf_off)
    assert labels_on.shape == (TRUE_LEN, 2)
