"""``embed_crops_yuv``'s CUDA graphs (``infer/graph_cache.py``).

On the CPU the cache's bookkeeping runs with a stand-in capture (no card is
needed): the first call of a key runs eagerly, the second captures, later
ones replay; a new shape starts again; the VOD path embeds a clip's last
chunk at the full chunk's shape; the least recently used graph goes
past the cap; new weights, an in-place edit, a move and ``train()`` drop a
graph; another module gets its own; hooks keep a module eager; a failed
capture leaves its key eager with one warning; a replay counts what the
capture counted, in the open span; a CPU input never builds a graph.

The tests marked ``card`` run on a CUDA card (``PLAYAID_TEST_TPU=1 python
-m pytest tests/test_torch_port_embed_graph.py -m card``: that variable
keeps ``conftest.py`` from importing JAX, which the card's machine lacks)
and skip elsewhere: a replay equals the eager call bit for bit for each
family, counts ``k2_blocks`` and ``k5_convs`` as the eager call does,
follows new weights, keeps the launch counts, waits for another
stream's replay, and two concurrent analyses through one pipeline label
as two sequential ones.
"""

import copy
import sys
import threading
import warnings

import numpy as np
import pytest
import torch
from torch import nn

from playaid_core_torch import profiling
from playaid_core_torch.infer import graph_cache
from playaid_core_torch.infer.graph_cache import CAPACITY, GraphCache
from playaid_core_torch.infer.pipeline import FAMILIES, BatchedActionPipeline
from playaid_core_torch.models.resnet import BasicBlock
from playaid_core_torch.ops.conv_block import residual_block_packed
from playaid_core_torch.ops.yuv import yuv420_to_rgb

torch.set_num_threads(2)


class Toy(nn.Module):
    """A module whose call counts what the embed's does: ``k2_blocks`` 5,
    one K4 launch and five K2 launches."""

    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(4, 3)
        self.block = BasicBlock(64, 64, fused=True)

    def forward(self, x):
        profiling.count("k2_blocks", 5)
        for wrapper, n in ((yuv420_to_rgb, 1), (residual_block_packed, 5)):
            for _ in range(n):
                graph_cache._build.count_launch(wrapper)
        return self.lin(x)


class StubGraph:
    """Stands in for ``CudaGraphCall``: the capture's counts, and a replay
    that runs the function with its counts held aside."""

    def __init__(self, fn, x):
        self.fn, self.runs = fn, 0
        with profiling.tally() as self.counts:
            fn(x.clone())

    def run(self, x):
        self.runs += 1
        with profiling.tally():
            return self.fn(x)


class Stub:
    """A capture function: the warm-up's output and a :class:`StubGraph`;
    ``fail`` raises instead, as a capture that CUDA refuses."""

    device_type = "cpu"

    def __init__(self, fail=False):
        self.fail, self.captured = fail, []

    def __call__(self, fn, x, shared):
        if self.fail:
            raise RuntimeError("operation not permitted when stream is capturing")
        out = fn(x)
        self.captured.append(StubGraph(fn, x))
        return out, self.captured[-1]


def make(fail=False):
    stub = Stub(fail)
    return GraphCache(capture=stub), stub, Toy().eval()


def x_of(rows, seed=0):
    return torch.randn(rows, 4, generator=torch.Generator().manual_seed(seed))


def replays(stub):
    return [g.runs for g in stub.captured]


def test_first_call_eager_second_captures_then_replays():
    cache, stub, toy = make()
    x = x_of(6)
    for call, want in enumerate(([], [0], [1], [2])):
        with torch.no_grad():
            out = cache(toy, toy, x)
            assert torch.equal(out, toy(x))
        assert replays(stub) == want, call
    assert len(cache.graphs()) == 1


def test_a_new_shape_runs_eagerly_again():
    cache, stub, toy = make()
    for _ in range(3):
        cache(toy, toy, x_of(6))
    cache(toy, toy, x_of(5))
    assert replays(stub) == [1]
    cache(toy, toy, x_of(5))
    cache(toy, toy, x_of(5))
    assert replays(stub) == [1, 1]


def test_the_least_recently_used_graph_goes_past_the_cap():
    cache, stub, toy = make()
    for rows in range(1, CAPACITY + 2):
        cache(toy, toy, x_of(rows))
        cache(toy, toy, x_of(rows))
    shapes = [key[2] for key in cache.graphs()]
    assert shapes == [(rows, 4) for rows in range(2, CAPACITY + 2)]
    cache(toy, toy, x_of(1))  # its graph is gone: eager, then captured again
    assert len(stub.captured) == CAPACITY + 1
    cache(toy, toy, x_of(1))
    assert len(stub.captured) == CAPACITY + 2
    assert [key[2] for key in cache.graphs()][-1] == (1, 4)


def _load(toy):
    toy.load_state_dict({k: v + 1 if v.is_floating_point() else v
                         for k, v in toy.state_dict().items()})


def _edit(toy):
    with torch.no_grad():
        toy.lin.weight.mul_(2)


def _move(toy):
    toy.double().float()


def _train_eval(toy):
    toy.train()
    toy.eval()


@pytest.mark.parametrize("change", [_load, _edit, _move, _train_eval],
                         ids=["load_state_dict", "in_place", "to", "train_eval"])
def test_a_change_of_what_the_graph_reads_rebuilds_it(change):
    cache, stub, toy = make()
    toy.block.block_pack(torch.float32)  # what a fused call on the card leaves
    x = x_of(6)
    for _ in range(3):
        cache(toy, toy, x)
    assert replays(stub) == [1]
    change(toy)
    toy.block.block_pack(torch.float32)
    with torch.no_grad():
        out = cache(toy, toy, x)  # dropped: eager
        assert torch.equal(out, toy(x))
    assert replays(stub) == [1] and cache.graphs() == []
    cache(toy, toy, x)
    cache(toy, toy, x)
    assert replays(stub) == [1, 1]


def test_a_train_mode_call_runs_eagerly():
    cache, stub, toy = make()
    for _ in range(3):
        cache(toy, toy, x_of(6))
    toy.train()
    cache(toy, toy, x_of(6))
    assert replays(stub) == [1]


def test_another_module_gets_graphs_of_its_own():
    """A mesh replica: a shallow copy of the pipeline with an embed of its
    own, sharing the pipeline's cache."""
    pipe = BatchedActionPipeline(crop_size=32, device="cpu").init(0)
    stub = Stub()
    pipe._graphs = GraphCache(capture=stub)
    replica = copy.copy(pipe)
    replica.embed = copy.deepcopy(pipe.embed)
    with torch.no_grad():
        replica.embed.fc.bias.add_(1.0)
    crops = torch.randint(0, 256, (4, 32 * 32 * 3 // 2), dtype=torch.uint8)
    outs = {}
    for _ in range(3):
        for name, p in (("pipe", pipe), ("replica", replica)):
            outs[name] = p.embed_crops_yuv(crops)
    assert replays(stub) == [1, 1] and len(pipe._graphs.graphs()) == 2
    assert stub.captured[0].fn.__self__ is pipe and stub.captured[1].fn.__self__ is replica
    torch.testing.assert_close(outs["replica"], outs["pipe"] + 1.0)


def test_hooks_keep_a_module_eager():
    cache, stub, toy = make()
    for _ in range(3):
        cache(toy, toy, x_of(6))
    seen = []
    hook = toy.lin.register_forward_hook(lambda m, i, o: seen.append(o))
    cache(toy, toy, x_of(6))
    hook.remove()
    cache(toy, toy, x_of(6))
    assert len(seen) == 1 and replays(stub) == [2]


def test_a_failed_capture_stays_eager_with_one_warning():
    cache, stub, toy = make(fail=True)
    x = x_of(6)
    cache(toy, toy, x)
    with pytest.warns(RuntimeWarning, match="runs eagerly from now on"):
        with torch.no_grad():
            assert torch.equal(cache(toy, toy, x), toy(x))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for _ in range(4):
            cache(toy, toy, x)
    assert cache.graphs() == []


def test_a_replay_counts_what_the_capture_counted_in_the_open_span():
    cache, stub, toy = make()
    launches = (yuv420_to_rgb.launches, residual_block_packed.launches)
    calls = 5
    with profiling.recording() as rec:
        for _ in range(calls):
            with profiling.span("playaid.embed", crops=6):
                cache(toy, toy, x_of(6))
    embeds = [s for s in rec.spans if s.name == "playaid.embed"]
    assert [s.counts for s in embeds] == (
        [{"crops": 6, "k2_blocks": 5}] * 2 + [{"crops": 6, "k2_blocks": 5, "graph_replays": 1}] * 3)
    summary = rec.summary()["playaid.embed"]
    assert (summary["k2_blocks"], summary["graph_replays"]) == (5 * calls, 3)
    assert (yuv420_to_rgb.launches - launches[0],
            residual_block_packed.launches - launches[1]) == (calls, 5 * calls)


def test_tally_holds_counts_off_the_recording():
    with profiling.recording() as rec:
        with profiling.span("playaid.embed"):
            with profiling.tally() as held:
                profiling.count("k2_blocks", 5)
                graph_cache._build.count_launch(yuv420_to_rgb, 2)
            profiling.count("crops", 1)
    assert held == {"k2_blocks": 5, yuv420_to_rgb: 2}
    assert rec.totals() == {"crops": 1} and profiling.tallying() is None


def test_threads_sharing_a_cache_each_get_their_own_answer():
    """16 threads, three shapes, switching every microsecond: one capture a
    shape, and every call the eager answer."""
    cache, stub, toy = make()
    errors = []

    def work(k):
        try:
            for i in range(30):
                x = x_of(4 + (k + i) % 3, seed=k * 100 + i)
                with torch.no_grad():
                    if not torch.equal(cache(toy, toy, x), toy(x)):
                        errors.append((k, i))
        except Exception as e:  # noqa: BLE001 - reported by the assert below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and len(stub.captured) == 3
    assert sum(replays(stub)) == 16 * 30 - 6


@pytest.mark.parametrize("family", FAMILIES)
def test_a_cpu_input_never_builds_a_graph(family):
    pipe = BatchedActionPipeline(family=family, crop_size=32, device="cpu").init(1)
    crops = torch.randint(0, 256, (4, 32 * 32 * 3 // 2), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        want = pipe.embed(yuv420_to_rgb(crops, 32))
    for _ in range(3):
        assert torch.equal(pipe.embed_crops_yuv(crops), want)
    assert pipe._graphs.graphs() == []


# ---- on the card ----

CROP, ROWS = 128, 48


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def card_crops(dev, seed=0, rows=ROWS):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (rows, CROP * CROP * 3 // 2), dtype=torch.uint8,
                         generator=gen).to(dev)


def eager(pipe, crops):
    with torch.inference_mode():
        return pipe._embed_yuv(crops)


@pytest.mark.card
@pytest.mark.parametrize("family", FAMILIES)
def test_card_replay_equals_the_eager_call(card, family):
    pipe = BatchedActionPipeline(family=family, device=card).init(5)
    crops = card_crops(card)
    want = eager(pipe, crops)
    with profiling.recording() as rec:
        outs = []
        for _ in range(4):
            with profiling.span("playaid.embed"):
                outs.append(pipe.embed_crops_yuv(crops))
    assert len(pipe._graphs.graphs()) == 1
    assert rec.summary()["playaid.embed"].get("graph_replays") == 2
    blocks = 5 if family != "resformer" else 0
    assert [s.counts.get("k2_blocks", 0) for s in rec.spans] == [blocks] * 4
    convs = 36 if family == "resformer" else 0  # ResNet-50's 1x1s on K5
    assert [s.counts.get("k5_convs", 0) for s in rec.spans] == [convs] * 4
    for out in outs:
        assert torch.equal(out, want)


@pytest.mark.card
def test_card_replay_follows_new_weights(card):
    pipe = BatchedActionPipeline(device=card).init(5)
    crops = card_crops(card)
    for _ in range(3):
        old = pipe.embed_crops_yuv(crops)
    other = BatchedActionPipeline(device=card).init(6)
    pipe.load_state_dicts({"embed": other.embed.state_dict(), "head": pipe.head.state_dict()})
    want = eager(pipe, crops)
    assert not torch.equal(want, old)
    for _ in range(4):
        assert torch.equal(pipe.embed_crops_yuv(crops), want)
    assert len(pipe._graphs.graphs()) == 1


@pytest.mark.card
def test_card_replays_keep_the_launch_counts(card):
    pipe = BatchedActionPipeline(device=card).init(5)
    crops = card_crops(card)
    calls = 6
    before = (yuv420_to_rgb.launches, residual_block_packed.launches)
    for _ in range(calls):
        pipe.embed_crops_yuv(crops)
    torch.cuda.synchronize()
    assert (yuv420_to_rgb.launches - before[0],
            residual_block_packed.launches - before[1]) == (calls, 5 * calls)


@pytest.mark.card
def test_card_replays_on_two_streams_wait_for_each_other(card):
    """Two graphs of one device share its memory pool: a replay on one
    stream right after the other's, on another, still gives the eager
    answer."""
    pipe = BatchedActionPipeline(device=card).init(5)
    crops = {rows: card_crops(card, seed=rows, rows=rows) for rows in (ROWS, ROWS // 2)}
    want = {rows: eager(pipe, x) for rows, x in crops.items()}
    for rows, x in crops.items():
        for _ in range(2):
            pipe.embed_crops_yuv(x)
    assert len(pipe._graphs.graphs()) == 2
    streams = {ROWS: torch.cuda.Stream(card), ROWS // 2: torch.cuda.Stream(card)}
    outs = []
    torch.cuda.synchronize()
    for _ in range(8):
        for rows, x in crops.items():
            with torch.cuda.stream(streams[rows]):
                outs.append((rows, pipe.embed_crops_yuv(x)))
    torch.cuda.synchronize()
    assert all(torch.equal(out, want[rows]) for rows, out in outs)


class StandInDecoder:
    """Seeded packed YUV420 crops for each frame of a video, in place of
    the native decoder (the card's machine has no libavcodec)."""

    def __init__(self, seed, frames, size=CROP):
        self.frames = frames
        self.crops = np.random.default_rng(seed).integers(
            0, 256, (frames, 2, size * size * 3 // 2), dtype=np.uint8)

    def decode_crops(self, start, boxes, out_size=128, padding=30, stride=1, out=None,
                     fmt="bgr", dense=False):
        rows = -(-boxes.shape[0] // stride)
        idx = np.minimum(start + stride * np.arange(rows), self.frames - 1)
        return max(0, min(boxes.shape[0], self.frames - start)), self.crops[idx]


def stand_in_sources(monkeypatch, sources):
    from playaid_core_torch.infer import vod_pipeline

    monkeypatch.setattr(vod_pipeline.native_decoder, "acquire",
                        lambda path, lowres=0, fast=False: sources[path])
    monkeypatch.setattr(vod_pipeline.native_decoder, "release", lambda dec: None)


def clip_boxes(frames):
    return np.tile(np.array([[0.3, 0.5, 0.1, 0.2], [0.7, 0.5, 0.1, 0.2]], np.float32),
                   (frames, 1, 1))


@pytest.mark.parametrize("workers", [1, 3], ids=["inline", "workers"])
def test_every_chunk_of_a_clip_reaches_the_embed_at_the_full_shape(workers, monkeypatch):
    """Clips whose lengths leave a short last chunk: the decoder pads it
    with empty rows, so the embed sees one shape, which one graph serves."""
    from playaid_core_torch.infer import vod_pipeline

    lengths = (50, 97, 130, 48)
    sources = {f"clip{k}.mp4": StandInDecoder(k, n, size=32) for k, n in enumerate(lengths)}
    stand_in_sources(monkeypatch, sources)
    pipe = BatchedActionPipeline(crop_size=32, device="cpu").init(0)
    shapes = []
    embed = pipe.embed_crops_yuv

    def recorded(crops):
        shapes.append(tuple(crops.shape))
        return embed(crops)

    pipe.embed_crops_yuv = recorded
    analyzer = vod_pipeline.VodAnalyzer(pipe, decode_backend="native", transfer_format="yuv420",
                                        stride=2, chunk=48, fast_decode=False,
                                        decode_workers=workers)
    for name, n in zip(sources, lengths):
        assert analyzer.analyze(name, clip_boxes(n))["frames"] == n
    assert shapes == [(48, 32 * 32 * 3 // 2)] * sum(-(-n // 48) for n in lengths)


@pytest.mark.card
def test_card_concurrent_analyses_label_as_sequential_ones(card, monkeypatch):
    from playaid_core_torch.infer import vod_pipeline

    frames = 960
    sources = {f"vod{k}.mp4": StandInDecoder(k, frames) for k in range(2)}
    stand_in_sources(monkeypatch, sources)
    boxes = clip_boxes(frames)
    kw = dict(decode_backend="native", transfer_format="yuv420", stride=2, chunk=48,
              fast_decode=False)
    pipe = BatchedActionPipeline(device=card).init(5)
    jobs = [(name, boxes) for name in sources]
    sequential = [vod_pipeline.VodAnalyzer(pipe, **kw).analyze(*job) for job in jobs]
    assert pipe._graphs.graphs()
    concurrent = vod_pipeline.analyze_many(jobs, pipeline=pipe, workers=2, **kw)
    for seq, con in zip(sequential, concurrent):
        assert not isinstance(con, Exception), con
        assert np.array_equal(seq["labels"], con["labels"])
        assert np.array_equal(seq["confidences"], con["confidences"])
