"""The shared all-reduce (``kernels.shared_allreduce``): the kernel that
sums a float32 vector over ranks sharing one card inside a captured CUDA
graph.

On the CPU: the C signatures ``kernels.build`` binds against the CUDA
sources (which only the card's machine compiles), and the error word's
reading. Marked ``cuda`` (skipped without a GPU): 2 ranks spawned on the
one card, the kernel against its plain version bit for bit, eager and
from replays of a captured graph with fresh inputs, and its refusals;
and a rank that skips a call, which its peer's wait reports in the
error word, after which the peer's calls return at once.
The plain version itself is held to the rank-order numpy sum on gloo
ranks by ``tests/test_torch_mesh_step.py``.
"""
import re

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import shared_allreduce as sa  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

SIZES = (2, 1001, 1 << 20)
REPLAYS = 20
# the timeout test: calls both ranks make before rank 1 skips one, and
# the wait's bound there (the module's own is a minute)
CALLS = 3
SHORT_TIMEOUT_S = 1.0


def _c_params(src: str, fname: str) -> int:
    """The number of parameters of ``extern "C" int fname(...)`` in
    ``src``."""
    m = re.search(r'extern "C" int ' + fname + r"\(([^)]*)\)", src)
    assert m, fname
    return len([p for p in m.group(1).split(",") if p.strip()])


@pytest.mark.parametrize("lib", sorted(build.SIGNATURES))
def test_signatures_match_the_sources(lib):
    """Every entry point ``build`` binds is declared in its library's
    source with as many parameters as ``argtypes`` gives ctypes (a
    mismatch would pass garbage on the card)."""
    src = (build.CSRC / f"{lib}.cu").read_text()
    for fname, argtypes in build.SIGNATURES[lib].items():
        assert _c_params(src, fname) == len(argtypes), (lib, fname)


@pytest.mark.parametrize("words,raises", [
    ([0, 0, 0, 0, 0], False), ([1, 3, 1, 17, 42], True)])
def test_error_word(words, raises):
    """Zeros pass; a set word raises, naming the rank, the peer it
    waited for and the call."""
    if not raises:
        sa.check_error(words)
        return
    with pytest.raises(RuntimeError) as e:
        sa.check_error(words)
    assert "rank 3" in str(e.value) and "rank 1" in str(e.value) \
        and "call 17" in str(e.value)


def _on_card(sizes, replays):
    """Rank body: the kernel against the plain version on this mesh."""
    import torch.distributed as dist
    dev = tmesh.rank_device("cuda")
    group = dist.group.WORLD
    n, rank = dist.get_world_size(), dist.get_rank()
    sar = sa.SharedAllReduce(group, dev)
    out = {}

    def part(size, q, k):
        g = torch.Generator(device=dev).manual_seed(1000 * k + 10 * q + 1)
        return torch.randn(size, generator=g, device=dev) * (q + 1)

    for size in sorted(sizes, reverse=True):       # the largest sizes first
        x = part(size, rank, 0)
        eager = torch.equal(sar.all_reduce(x.clone()),
                            sa.plain_all_reduce(x.clone(), group))
        inp, buf = x.clone(), torch.empty_like(x)
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            sar.all_reduce(buf.copy_(inp))
        replayed = True
        for k in range(1, replays + 1):
            inp.copy_(part(size, rank, k))
            graph.replay()
            want = sa.rank_order_sum([part(size, q, k) for q in range(n)])
            replayed = replayed and torch.equal(buf, want)
        out[size] = (bool(eager), bool(replayed))
    refused = []
    try:
        sar.all_reduce(torch.ones(4, dtype=torch.float64, device=dev))
    except TypeError:
        refused.append("float64")
    big = torch.zeros(sar.cap + 1, device=dev)
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    try:
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=stream):
            sar.all_reduce(big)
    except RuntimeError as e:
        refused.append("capture" if "during a capture" in str(e) else str(e))
    out["refused"] = refused
    out["error"] = sar.error.tolist()
    out["runs"] = sar.executions()
    sar.release()
    return out


@pytest.mark.cuda
def test_shared_all_reduce_on_card():
    """2 ranks on the one card: eager and replayed sums equal the plain
    rank-order sum bit for bit at 2, 1001 and 2^20 floats; float64 and a
    message past the buffers during a capture are refused; the error
    word stays 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    ranks = tmesh.run_ranks(2, _on_card, SIZES, REPLAYS, device_type="cuda",
                            timeout=300)
    for out in ranks:
        for size in SIZES:
            assert out[size] == (True, True), (size, out[size])
        assert out["refused"] == ["float64", "capture"]
        assert out["error"] == [0] * 5
        assert out["runs"] == len(SIZES) * (1 + REPLAYS)


def _skipped_call(calls, timeout_s):
    """Rank body: both ranks make ``calls`` calls, then rank 0 one more
    that rank 1 skips (it times out) and one after it (timed: it must
    return at once). Returns the error word and rank 0's two times."""
    import time
    import torch.distributed as dist
    sa.TIMEOUT_S = timeout_s               # read when the object is built
    dev = tmesh.rank_device("cuda")
    group = dist.group.WORLD
    rank = dist.get_rank()
    sar = sa.SharedAllReduce(group, dev)
    x = torch.ones(1001, device=dev)
    for _ in range(calls):
        sar.all_reduce(x)
    torch.cuda.synchronize(dev)
    sums = float(x[0])
    seconds = []
    if rank == 0:
        for _ in range(2):
            t0 = time.perf_counter()
            sar.all_reduce(x)
            torch.cuda.synchronize(dev)
            seconds.append(time.perf_counter() - t0)
    dist.barrier(group=group)       # rank 1 keeps its buffer until here
    out = {"error": sar.error.tolist(), "seconds": seconds, "sum": sums}
    try:
        sa.check_error(out["error"])
        out["raised"] = ""
    except RuntimeError as e:
        out["raised"] = str(e)
    sar.release()
    return out


@pytest.mark.cuda
def test_shared_all_reduce_reports_a_skipped_call():
    """Rank 1 skips rank 0's call number CALLS: rank 0's wait ends after
    its (shortened) timeout with the error word (1, rank 0, peer 1, call
    CALLS, sequence CALLS + 1), which ``check_error`` raises on; rank
    0's next call returns at once instead of waiting again; rank 1's
    word stays 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    r0, r1 = tmesh.run_ranks(2, _skipped_call, CALLS, SHORT_TIMEOUT_S,
                             device_type="cuda", timeout=300)
    assert r0["sum"] == r1["sum"] == 2.0 ** CALLS
    assert r0["error"] == [1, 0, 1, CALLS, CALLS + 1]
    assert "rank 0" in r0["raised"] and "for rank 1" in r0["raised"] \
        and f"call {CALLS}" in r0["raised"]
    timed_out, after = r0["seconds"]
    assert timed_out >= SHORT_TIMEOUT_S and after < SHORT_TIMEOUT_S / 4
    assert r1["error"] == [0] * 5 and r1["raised"] == ""
