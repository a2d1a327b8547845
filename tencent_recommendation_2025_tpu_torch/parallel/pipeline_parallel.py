"""Pipeline parallelism: a GPipe schedule of stacked blocks over a ``pipe``
axis.

Counterpart of ``tencent_recommendation_2025_tpu/parallel/pipeline_parallel
.py``'s ``pipelined_scan``, with its contract: ``block_fn(act, block_params)
-> act`` applies one block to one microbatch, ``act`` is a dict of
``[rows, ...]`` tensors (the hidden states and per-token side inputs, which
ride the conveyor together), the stacked block leaves' leading axis is
sharded over the stages (stage p holds blocks [p NB / S, (p + 1) NB / S)),
microbatch i of M starts on stage i % S, the schedule runs ``M + S - 1``
ticks in which stage s works on microbatch t - s, and every output returns
to the stage it started on, so the caller's reassembly is a reshape.

The JAX package rotates whole buffers around the ring each tick, because
``shard_map`` has no point-to-point send; here the transfers are direct:

- **Local mesh** (every stage in this process): the stages are a list, a
  tick hands each stage's output to the next one by indexing, and autograd
  differentiates the whole schedule.
- **Process mesh** (one card a stage): a tick moves each activation one hop
  between the ranks of one data column, by point-to-point sends on the
  column's pipe group (``ProcessMesh.pipe_group``): microbatch t from its
  home stage to stage 0, stage s's output to stage s + 1, the last
  stage's output back home. Each process's whole schedule is one
  ``torch.autograd.Function`` (:class:`_ProcessSchedule`): its forward
  keeps every microbatch's stage graph, built on detached inputs, and its
  backward walks the ticks in reverse, receiving each output's cotangent,
  differentiating that microbatch's graph (``torch.autograd.grad``) and
  sending the input's cotangent back, with every send and receive paired
  in one order on both sides. No receive waits inside the autograd
  engine's own ordering, so the backward cannot deadlock. The stage's
  block gradients are summed over its microbatches in microbatch order.

Layout. The rows of one shard of the (pipe, data)-sharded batch
(``mesh.data_indices``) split into ``M / S`` contiguous microbatches, its
slots. On a process mesh slot j of the rank at pipe index p is its
column's microbatch ``j * S + p``, the JAX package's cyclic layout; a local
mesh runs each shard's slots through the list of stages on their own
(:func:`shard_schedule`), as the encoder does. Both give every row the
JAX result, since a block treats each row on its own.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import torch
import torch.distributed as dist


def _as_act(x) -> Dict[str, torch.Tensor]:
    return dict(x) if isinstance(x, dict) else {"_": x}


def _from_act(act: Dict[str, torch.Tensor], like):
    return act if isinstance(like, dict) else act["_"]


def _index(tree, i):
    """Leaf ``i`` of the leading axis of every tensor of a nested dict."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    return next(it)


def _blocks_of(stage_params) -> int:
    return _leaves(stage_params)[0].shape[0]


def apply_stage(block_fn: Callable, stage_params, act: dict) -> dict:
    """One stage on one microbatch: ``block_fn`` over its stacked blocks in
    order."""
    for b in range(_blocks_of(stage_params)):
        act = block_fn(act, _index(stage_params, b))
    return act


def _split(act: dict, n: int) -> List[dict]:
    """``act`` as ``n`` contiguous microbatches of its rows."""
    parts = {k: v.chunk(n) for k, v in act.items()}
    return [{k: parts[k][j] for k in act} for j in range(n)]


def _cat(acts: Sequence[dict]) -> dict:
    return {k: torch.cat([a[k] for a in acts]) for k in acts[0]}


def _check(S: int, M: int, column_rows: int) -> None:
    # the JAX function's asserts, with its messages
    assert M % S == 0, f"microbatches {M} not divisible by stages {S}"
    assert column_rows % M == 0, \
        f"batch {column_rows} not divisible by microbatches {M}"


def local_schedule(block_fn: Callable, stages: Sequence[Any],
                   microbatches: Sequence[dict]) -> List[dict]:
    """The GPipe ticks over ``stages`` (one stacked parameter tree each) in
    one process: tick t runs stage s on microbatch t - s and hands its
    output to stage s + 1 by indexing. Returns the microbatches' outputs in
    order. Differentiable: autograd records the whole schedule."""
    S, M = len(stages), len(microbatches)
    held: List[Any] = [None] * S     # the microbatch each stage works on
    out: List[Any] = [None] * M
    for t in range(M + S - 1):
        # the conveyor moves first: stage s takes stage s - 1's output
        for s in range(S - 1, 0, -1):
            held[s] = held[s - 1]
        held[0] = microbatches[t] if t < M else None
        for s in range(S):
            if held[s] is not None:
                held[s] = apply_stage(block_fn, stages[s], held[s])
        if t - (S - 1) >= 0:
            out[t - (S - 1)] = held[S - 1]
    return out


def stage_slices(stage_params, S: int) -> List[Any]:
    """The whole stacked tree cut into its S stages' consecutive blocks."""
    k = _blocks_of(stage_params) // S
    return [_index(stage_params, slice(s * k, (s + 1) * k))
            for s in range(S)]


def shard_schedule(mesh, block_fn: Callable, stage_params, act: dict,
                   M: int) -> dict:
    """One data shard's rows (``act``) through its column's schedule of M
    microbatches, its M / S slots: this process's part of the schedule on
    a process mesh (:func:`process_schedule`; ``stage_params`` its
    stage's blocks), on a local mesh its microbatches through the list of
    stages (:func:`local_schedule`; ``stage_params`` whole). Returns the
    rows' outputs."""
    S = mesh.shape["pipe"]
    if mesh.process:
        return process_schedule(mesh, block_fn, stage_params, act, M)
    done = local_schedule(block_fn, stage_slices(stage_params, S),
                          _split(act, M // S))
    return _cat(done)


def pipelined_scan(mesh, block_fn: Callable, stage_params, x,
                   num_microbatches: int):
    """``block_fn`` over every stacked block, as a GPipe schedule over the
    ``pipe`` axis of ``mesh`` (see the module docstring).

    ``stage_params``: the stacked block tree, whole (leading axis NB) on a
    local mesh, this stage's NB / S blocks on a process mesh. ``x``: a
    tensor or a dict of ``[rows, ...]`` tensors, the rows this process
    holds of the (pipe, data)-sharded batch (every shard's, in shard order,
    on a local mesh). Returns the same structure at the blocks' output."""
    S, D = mesh.shape["pipe"], mesh.shape["data"]
    M = num_microbatches
    act = _as_act(x)
    if not isinstance(x, dict):
        fn = block_fn

        def block_fn(a, bp):
            return {"_": fn(a["_"], bp)}
    rows = next(iter(act.values())).shape[0]
    if mesh.process:
        _check(S, M, rows * S)
        shards = [act]
    else:
        if rows % (S * D):
            raise ValueError(f"{rows} rows do not split into pipe {S} x "
                             f"data {D} shards")
        _check(S, M, rows // D)
        shards = _split(act, S * D)
    return _from_act(_cat([shard_schedule(mesh, block_fn, stage_params, a, M)
                           for a in shards]), x)


# ---------------------------------------------------------------------------
# the process mesh
# ---------------------------------------------------------------------------

def _transfers(c: int, S: int, M: int):
    """The hops of communication phase c (before tick c; the phase after
    the last tick is M + S - 1): (src stage, dst stage, microbatch, kind)
    in one global order, which both ends of every hop follow."""
    out = []
    if c < M:                                   # feed: home -> stage 0
        out.append((c % S, 0, c, "in"))
    for s in range(S - 1):                      # the conveyor
        i = c - 1 - s
        if 0 <= i < M:
            out.append((s, s + 1, i, "fwd"))
    i = c - S                                   # the last stage -> home
    if 0 <= i < M:
        out.append((S - 1, i % S, i, "out"))
    return out


def _exchange(mesh, sends, recvs) -> None:
    """Post every send ``(tensor, dst stage)`` and receive ``(buffer, src
    stage)`` of one phase in one batch and wait for them all."""
    ops = [dist.P2POp(dist.isend, t.contiguous(), mesh.pipe_ranks[dst],
                      group=mesh.pipe_group) for t, dst in sends]
    ops += [dist.P2POp(dist.irecv, buf, mesh.pipe_ranks[src],
                       group=mesh.pipe_group) for buf, src in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


class _Plan:
    """What one process's schedule needs besides its tensors."""

    def __init__(self, mesh, block_fn, M, keys, params_tree):
        self.mesh, self.block_fn, self.M = mesh, block_fn, M
        self.keys, self.params_tree = keys, params_tree


def _run(plan: _Plan, home: List[dict], params, record: bool):
    """The forward ticks of this stage: returns (this home's outputs by
    slot, and where ``record``, {microbatch: (input leaves, output
    leaves)} of the graphs built on detached inputs)."""
    mesh, M = plan.mesh, plan.M
    S, p = mesh.shape["pipe"], mesh.pipe_index
    m_loc = M // S
    done: List[Any] = [None] * m_loc
    graphs = {}
    held = None          # (microbatch, act) this stage holds after a tick
    inbox = {}           # microbatch -> act received for this tick
    like = home[0]
    for c in range(M + S):
        sends, recvs, local = [], [], []
        for src, dst, i, kind in _transfers(c, S, M):
            if src != p and dst != p:
                continue
            if kind == "in":
                what = home[i // S] if src == p else None
            else:
                what = held[1] if src == p else None
                assert src != p or held[0] == i
            if src == p and dst == p:
                local.append((i, kind, what))
                continue
            if src == p:
                sends += [(what[k], dst) for k in plan.keys]
            else:
                bufs = {k: torch.empty_like(like[k]) for k in plan.keys}
                recvs += [(bufs[k], src) for k in plan.keys]
                local.append((i, kind, bufs))
        _exchange(mesh, sends, recvs)
        for i, kind, act in local:
            if kind == "out":
                done[i // S] = act
            else:
                inbox[i] = act
        if c == M + S - 1:
            break
        i = c - p                                 # this tick's microbatch
        held = None
        if 0 <= i < M:
            act = inbox.pop(i)
            if record:
                inp = {k: v.detach().requires_grad_(v.is_floating_point())
                       for k, v in act.items()}
                with torch.enable_grad():
                    out = apply_stage(plan.block_fn, params, inp)
                graphs[i] = (inp, out)
                act = {k: v.detach() for k, v in out.items()}
            else:
                act = apply_stage(plan.block_fn, params, act)
            held = (i, act)
    return done, graphs


class _ProcessSchedule(torch.autograd.Function):
    """One process's whole schedule (see the module docstring). Inputs: the
    plan, this home's activation leaves ``[rows, ...]`` in ``plan.keys``
    order, then the stage's parameter leaves; outputs: the home's output
    leaves."""

    @staticmethod
    def forward(ctx, plan, *tensors):
        n = len(plan.keys)
        home_t, par_t = tensors[:n], tensors[n:]
        m_loc = plan.M // plan.mesh.shape["pipe"]
        home = _split(dict(zip(plan.keys, home_t)), m_loc)
        params = [t.detach().requires_grad_(t.is_floating_point()
                                            and t.requires_grad)
                  for t in par_t]
        tree = _rebuild(plan.params_tree, iter(params))
        done, graphs = _run(plan, home, tree, record=True)
        ctx.plan, ctx.graphs, ctx.params = plan, graphs, params
        ctx.home_like = [{k: v for k, v in mb.items()} for mb in home]
        out = _cat(done)
        res = tuple(out[k] for k in plan.keys)
        ctx.mark_non_differentiable(*[r for r in res
                                      if not r.is_floating_point()])
        return res

    @staticmethod
    def backward(ctx, *cots):
        plan, graphs, params = ctx.plan, ctx.graphs, ctx.params
        mesh, M = plan.mesh, plan.M
        S, p = mesh.shape["pipe"], mesh.pipe_index
        m_loc = M // S
        fkeys = [k for k in plan.keys
                 if ctx.home_like[0][k].is_floating_point()]
        like = ctx.home_like[0]
        # the home's output cotangents, by slot
        home_cot = _split({k: (c if c is not None else
                               torch.zeros_like(torch.cat(
                                   [mb[k] for mb in ctx.home_like])))
                           for k, c in zip(plan.keys, cots)
                           if k in fkeys}, m_loc)
        d_home: List[Any] = [None] * m_loc
        d_params: Dict[int, List[Any]] = {}
        cot_in = {}      # microbatch -> cotangent of this stage's output
        sent = None      # (microbatch, cotangent of this stage's input)
        for c in range(M + S - 1, -1, -1):
            # phase c reversed: each hop's cotangent goes dst -> src
            sends, recvs, local = [], [], []
            for src, dst, i, kind in _transfers(c, S, M):
                if src != p and dst != p:
                    continue
                if dst == p:               # this end sends the cotangent
                    if kind == "out":
                        what = home_cot[i // S]
                    else:
                        assert sent is not None and sent[0] == i
                        what = sent[1]
                    if src == p:
                        local.append((i, kind, what))
                        continue
                    sends += [(what[k], src) for k in fkeys]
                else:
                    bufs = {k: torch.empty_like(like[k]) for k in fkeys}
                    recvs += [(bufs[k], dst) for k in fkeys]
                    local.append((i, kind, bufs))
            _exchange(mesh, sends, recvs)
            for i, kind, cot in local:
                if kind == "in":
                    d_home[i // S] = cot
                else:
                    cot_in[i] = cot
            sent = None
            if c == 0:
                break
            t = c - 1                          # the tick before phase c
            i = t - p
            if 0 <= i < M:
                inp, out = graphs.pop(i)
                cot = cot_in.pop(i)
                outs = [out[k] for k in fkeys if out[k].requires_grad]
                gouts = [cot[k] for k in fkeys if out[k].requires_grad]
                ins = [inp[k] for k in fkeys]
                wrt = ins + [t_ for t_ in params if t_.requires_grad]
                grads = torch.autograd.grad(outs, wrt, gouts,
                                            allow_unused=True) \
                    if outs else [None] * len(wrt)
                grads = [torch.zeros_like(w) if g is None else g
                         for g, w in zip(grads, wrt)]
                sent = (i, dict(zip(fkeys, grads[:len(ins)])))
                d_params[i] = grads[len(ins):]
        # the stage's block gradients summed in microbatch order
        total = None
        for i in sorted(d_params):
            total = list(d_params[i]) if total is None else \
                [a + b for a, b in zip(total, d_params[i])]
        it = iter(total or [])
        gpar = [next(it) if t_.requires_grad else None for t_ in params]
        d_cat = {k: torch.cat([d[k] for d in d_home]) for k in fkeys}
        ghome = [d_cat.get(k) for k in plan.keys]
        return (None, *ghome, *gpar)


def process_schedule(mesh, block_fn: Callable, stage_params, act: dict,
                     M: int) -> dict:
    """This process's stage of the column's schedule over ``act``, its
    rows (``M / S`` microbatches); differentiable through
    :class:`_ProcessSchedule` where autograd records, a plain forward
    otherwise. Returns its rows' outputs."""
    keys = sorted(act)
    leaves = _leaves(stage_params)
    plan = _Plan(mesh, block_fn, M, keys, stage_params)
    grad = torch.is_grad_enabled() and (
        any(t.requires_grad for t in leaves)
        or any(act[k].requires_grad for k in keys))
    if not grad:
        home = _split(act, M // mesh.shape["pipe"])
        done, _ = _run(plan, home, stage_params, record=False)
        return _cat(done)
    out = _ProcessSchedule.apply(plan, *[act[k] for k in keys], *leaves)
    return dict(zip(keys, out))
