"""The kernels a CUDA graph launches, read from its nodes.

`kernels_on_card(fn)` captures one call of fn() into a CUDA graph and reads
its nodes back through the CUDA driver API (libcuda): each kernel node by
its function's (mangled) name, in launch order, any other node (a memory
copy or set) by its type. Unlike a profiler session, which now and then
records no device activity at all, the capture either lists every launch or
raises. `kernel_counts(graph)` counts the kernel nodes of a graph captured
with `keep_graph=True` by name (what each replay launches).

    from bagel_tpu_torch.utils.cuda_graph import kernels_on_card
    names = kernels_on_card(lambda: flash.flash_cached_attention(q, k, v, p, n, causal=True))
"""

from __future__ import annotations

import collections
import ctypes

import torch

_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty"}


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 (cuda.h)."""

    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def _driver():
    lib = ctypes.CDLL("libcuda.so.1")

    def call(name, *args):
        err = getattr(lib, name)(*args)
        if err != 0:
            raise RuntimeError(f"{name} failed with CUresult {err}")

    return call


def _ordered(call, graph) -> list:
    """The graph's nodes with every node after the nodes it depends on."""
    count = ctypes.c_size_t(0)
    call("cuGraphGetNodes", graph, None, ctypes.byref(count))
    nodes = (ctypes.c_void_p * count.value)()
    call("cuGraphGetNodes", graph, nodes, ctypes.byref(count))
    # the _v2 query with its edge data: a capture's edges carry data, and
    # the first query, without it, refuses them (CUDA_ERROR_LOSSY_QUERY)
    n_edges = ctypes.c_size_t(0)
    call("cuGraphGetEdges_v2", graph, None, None, None, ctypes.byref(n_edges))
    src = (ctypes.c_void_p * n_edges.value)()
    dst = (ctypes.c_void_p * n_edges.value)()
    data = (ctypes.c_uint64 * n_edges.value)()  # CUgraphEdgeData: 8 bytes an edge
    if n_edges.value:
        call("cuGraphGetEdges_v2", graph, src, dst, data, ctypes.byref(n_edges))
    after = {node: [] for node in nodes}
    waits = {node: 0 for node in nodes}
    for a, b in zip(src, dst):
        after[a].append(b)
        waits[b] += 1
    ready = [node for node in nodes if waits[node] == 0]
    order = []
    while ready:
        node = ready.pop(0)
        order.append(node)
        for nxt in after[node]:
            waits[nxt] -= 1
            if waits[nxt] == 0:
                ready.append(nxt)
    return order


def kernels_on_card(fn) -> list:
    """The names of the kernels one call of fn() launches on the card, in
    launch order, after one call outside the capture (which builds any
    kernel and workspace); a memory copy or set is listed by its type. fn
    must not synchronize with the host."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    call = _driver()
    known: dict = {}
    names = []
    for node in _ordered(call, ctypes.c_void_p(g.raw_cuda_graph())):
        kind, name = _node(call, node, known)
        names.append(name if kind == 0 else _NODE_TYPES.get(kind, f"node type {kind}"))
    del g
    return names


def _node(call, node, known: dict) -> tuple:
    """(the node's type, its kernel's name or None); `known` caches the names
    by function."""
    kind = ctypes.c_int(-1)
    call("cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
    if kind.value != 0:
        return kind.value, None
    params = _KernelNodeParams()
    call("cuGraphKernelNodeGetParams_v2", ctypes.c_void_p(node), ctypes.byref(params))
    fn = (params.func, params.kern)
    if fn not in known:
        name = ctypes.c_char_p()
        if params.func:
            call("cuFuncGetName", ctypes.byref(name), ctypes.c_void_p(params.func))
        else:
            call("cuKernelGetName", ctypes.byref(name), ctypes.c_void_p(params.kern))
        known[fn] = name.value.decode()
    return 0, known[fn]


def kernel_counts(graph: "torch.cuda.CUDAGraph") -> collections.Counter:
    """The kernel nodes of a captured graph (made with keep_graph=True), by
    kernel name: what one replay launches."""
    call = _driver()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    call("cuGraphGetNodes", raw, None, ctypes.byref(count))
    nodes = (ctypes.c_void_p * count.value)()
    call("cuGraphGetNodes", raw, nodes, ctypes.byref(count))
    known: dict = {}
    kinds = (_node(call, node, known) for node in nodes)
    return collections.Counter(name for kind, name in kinds if kind == 0)
