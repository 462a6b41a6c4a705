"""recurrent_group / memory / gru_step_layer — the port of
``paddle_tpu/layers/recurrent_group.py``'s training path (≅ the reference's
``RecurrentGradientMachine`` and ``trainer_config_helpers/layers.py``
``memory`` and ``recurrent_group``).

The step sub-graph is built ONCE symbolically from placeholder nodes and
evaluated once per time step by a Python loop over the padded time axis
(the JAX package's ``lax.scan``), each memory frozen past its row's
length by the governing sequence's mask.  Two routes leave the loop:

- a step that is exactly one standard ``gru_step`` on its memory runs the
  GRU sequence kernel (``ops/rnn.gru_fused``) instead;
- the feed-forward tail of the step (layers that feed no memory, e.g. the
  NMT decoder's 30,000-way softmax fc) is *sunk*: it runs once on the
  time-stacked sequence, one [B*T, H] x [H, V] product instead of T small
  ones, and a softmax fc tail hands ``classification_cost`` its logits
  (``__fc_logits__``) through the group.

Beam-search generation (``beam_search``, ``GeneratedInput``) and nested
groups (``SubsequenceInput``) are not ported yet (ROADMAP A4b): they
raise ``NotImplementedError``."""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from paddle_tpu_torch.core import initializer as I
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.lod import SequenceBatch
from paddle_tpu_torch.layers import base as layer_base
from paddle_tpu_torch.layers.base import (Context, LayerOutput, evaluate,
                                          gen_name)

_GENERATION = ("beam-search generation and nested recurrent groups are "
               "not ported yet (ROADMAP A4b)")


class StaticInput:
    """Read-only per-batch value imported unchanged into every step
    (≅ StaticInput): a plain vector or a whole sequence (the attention
    case: the encoder's outputs)."""

    def __init__(self, input: LayerOutput, is_seq: bool = False, size=None):
        enforce(isinstance(input, LayerOutput),
                "StaticInput wraps a LayerOutput")
        self.input = input


class SubsequenceInput:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_GENERATION)


class GeneratedInput:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_GENERATION)


def beam_search(*args, **kwargs):
    raise NotImplementedError(_GENERATION)


def memory(name: str | None, size: int, boot_layer: LayerOutput | None = None,
           boot_bias=None, boot_bias_active_type=None,
           boot_with_const_id: int | None = None, is_seq: bool = False,
           memory_name: str | None = None) -> LayerOutput:
    """≅ memory: inside a step function, the previous step's value of the
    layer called ``name``.  The first step reads ``boot_layer``'s (outer)
    value, a constant id, or zeros."""
    enforce(not is_seq, "sequence-level memory not supported yet")
    enforce(boot_bias is None,
            "memory boot_bias is not implemented; pass boot_layer instead")
    node = LayerOutput(name=memory_name or gen_name("memory"),
                       layer_type="__memory__", size=size,
                       attrs={"link": name,
                              "boot_const": boot_with_const_id})
    node._boot_layer = boot_layer
    node._link_override = None
    node.set_input = lambda layer: setattr(node, "_link_override", layer)
    return node


def _collect_step_graph(outs: Sequence[LayerOutput]):
    """Walk the step sub-DAG, stopping at placeholder and memory leaves."""
    seq_phs, static_phs, mems, nodes = [], [], [], []
    seen = set()

    def visit(n: LayerOutput):
        if id(n) in seen:
            return
        seen.add(id(n))
        leaves = {"__step_input__": seq_phs, "__static_input__": static_phs,
                  "__memory__": mems}
        if n.layer_type in leaves:
            leaves[n.layer_type].append(n)
            return
        enforce(n.layer_type != "data",
                f"layer {n.name!r}: outer values must enter a "
                "recurrent_group via StaticInput")
        for p in n.parents:
            visit(p)
        nodes.append(n)

    for o in outs:
        visit(o)
    return nodes, seq_phs, static_phs, mems


def _resolve_links(mems, step_nodes):
    """Each memory's step node: the layer whose output it carries."""
    by_name = {n.name: n for n in step_nodes}
    linked = []
    for m in mems:
        if m._link_override is not None:
            linked.append(m._link_override)
            continue
        link = m.attrs["link"]
        enforce(link is not None, "memory() needs a name= linking it to a "
                                  "layer defined in the step function")
        tgt = by_name.get(link)
        enforce(tgt is not None, f"memory links to layer {link!r} but no "
                "layer with that name exists in the step function")
        linked.append(tgt)
    return linked


def _raw_boot(v):
    return v.data if isinstance(v, SequenceBatch) else v


def _boot_value(mem, boot_val, batch, dtype, device):
    if boot_val is not None:
        return boot_val
    const = mem.attrs.get("boot_const")
    return torch.full((batch, mem.size), 0.0 if const is None
                      else float(const), dtype=dtype, device=device)


#: sink-the-tail switch (tests turn it off to hold the sunk path against
#: the per-step one)
SINK_SCAN_TAIL = True

_SINKABLE = {"fc", "mixed", "addto", "slope_intercept", "scaling"}


def _sink_tail(out, link_targets, seq_phs, static_phs):
    """(sunk tail nodes, the step nodes whose stacked values feed them):
    the output-side step nodes that feed no memory and only per-step
    values.  A tail that reads a static input does not sink (its per-step
    value is the whole sequence)."""
    needed, stack = set(), list(link_targets)
    while stack:
        nd = stack.pop()
        if id(nd) not in needed:
            needed.add(id(nd))
            stack.extend(nd.parents)
    if id(out) in needed:
        return [], []
    sunk, frontier, pending, seen = [], [], [out], set()
    while pending:
        nd = pending.pop()
        if id(nd) in seen:
            continue
        seen.add(id(nd))
        if (nd.layer_type not in _SINKABLE or nd.state_specs
                or nd.attrs.get("drop_rate")):
            return [], []
        sunk.append(nd)
        for p in nd.parents:
            # the static check first: a static input that also feeds the
            # recurrence is in `needed`, and must still reject the sink
            if any(p is ph for ph in static_phs):
                return [], []
            if any(p is ph for ph in seq_phs):
                continue
            if id(p) in needed:
                if not any(p is f for f in frontier):
                    frontier.append(p)
            else:
                pending.append(p)
    return (sunk, frontier) if frontier else ([], [])


def recurrent_group(step: Callable, input, reverse: bool = False,
                    name: str | None = None):
    """≅ recurrent_group: scatters the sequence inputs into steps, runs
    ``step`` on each, gathers its one output back into a sequence with
    the first sequence input's lengths.  Several outputs and
    ``targetInlink`` come with generation (ROADMAP A4b)."""
    name = name or gen_name("recurrent_group")
    reg_start = len(layer_base.layer_registry())
    if isinstance(input, (LayerOutput, StaticInput)):
        input = [input]
    input = list(input)
    enforce(len(input) > 0, "recurrent_group needs at least one input")

    # placeholders, then the user's step function on them
    in_args, seq_inputs, static_inputs = [], [], []
    for each in input:
        if isinstance(each, StaticInput):
            ph = LayerOutput(name=gen_name("static_in"),
                             layer_type="__static_input__",
                             size=each.input.size)
            static_inputs.append(each.input)
        else:
            enforce(isinstance(each, LayerOutput), "recurrent_group inputs "
                    "must be LayerOutput or StaticInput")
            ph = LayerOutput(name=gen_name("step_in"),
                             layer_type="__step_input__", size=each.size)
            seq_inputs.append(each)
        in_args.append(ph)
    enforce(len(seq_inputs) > 0,
            "recurrent_group needs at least one sequence input")

    out = step(*in_args)
    enforce(isinstance(out, LayerOutput), "recurrent_group: the step must "
            "return one LayerOutput (several outputs are ROADMAP A4b)")
    outs = [out]
    # every node step() built, in creation order: this also finds layers
    # reachable only through a memory link
    created = layer_base.layer_registry()[reg_start:]

    step_nodes, _, _, mems = _collect_step_graph(outs)
    link_targets = _resolve_links(mems, step_nodes + [
        n for n in created if n.layer_type not in (
            "__memory__", "__step_input__", "__static_input__")])
    roots = list(outs)
    for t in link_targets:
        if not any(t is r for r in roots):
            roots.append(t)
    # re-collect, so link-only layers join the step graph
    step_nodes, _, _, mems2 = _collect_step_graph(roots)
    for m in mems2:
        if not any(m is x for x in mems):
            mems.append(m)
            link_targets.append(_resolve_links([m], step_nodes)[0])

    seq_phs = [ph for ph in in_args if ph.layer_type == "__step_input__"]
    static_phs = [ph for ph in in_args
                  if ph.layer_type == "__static_input__"]
    boot_layers = [m._boot_layer for m in mems]
    parents = (tuple(seq_inputs) + tuple(static_inputs)
               + tuple(b for b in boot_layers if b is not None))
    param_specs, state_specs = {}, {}
    for n in step_nodes:
        for s in n.param_specs:
            param_specs.setdefault(s.name, s)
        for s in n.state_specs:
            state_specs.setdefault(s.name, s)
    param_specs = tuple(param_specs.values())
    state_specs = tuple(state_specs.values())
    n_seq, n_static = len(seq_inputs), len(static_inputs)

    # -- a step that is exactly one standard gru_step on its memory runs
    # the GRU sequence kernel: the same freeze-mask semantics, parameters
    # and config; only the runtime closure changes
    fused_fwd = None
    g_node = out
    if (g_node.layer_type == "gru_step"
            and len(step_nodes) == 1 and len(mems) == 1
            and link_targets[0] is g_node and n_seq == 1 and not n_static
            and len(g_node.parents) == 2 and g_node.parents[0] in seq_phs
            and g_node.parents[1] is mems[0]
            and g_node.attrs.get("active_type") == "tanh"
            and g_node.attrs.get("active_gate_type") == "sigmoid"):
        from paddle_tpu_torch.ops import rnn as rnn_ops

        g_mem, g_has_boot = mems[0], boot_layers[0] is not None

        def fused_fwd(ctx, params, states, *parent_values):
            seq = parent_values[0]
            enforce(isinstance(seq, SequenceBatch),
                    "recurrent_group sequence inputs must be sequences")
            boot = _raw_boot(parent_values[1]) if g_has_boot else None
            init = _boot_value(g_mem, boot, seq.batch_size, seq.data.dtype,
                               seq.data.device)
            xw = seq.data
            bias_name = g_node.attrs.get("bias_spec")
            if bias_name:
                xw = xw + params[bias_name]
            w = params[g_node.param_specs[0].name]
            d = g_node.size
            out, _ = rnn_ops.gru_fused(SequenceBatch(xw, seq.length),
                                       w[:, :2 * d], w[:, 2 * d:], init,
                                       reverse=reverse)
            return out

    sunk, frontier = ([], [])
    if fused_fwd is None and not reverse and SINK_SCAN_TAIL:
        sunk, frontier = _sink_tail(out, link_targets, seq_phs, static_phs)
    inner_outs = frontier if sunk else outs
    if sunk:
        # the loop evaluates only the recurrence and the frontier
        loop_roots = []
        for n in list(link_targets) + list(frontier):
            if not any(n is r for r in loop_roots):
                loop_roots.append(n)
    else:
        loop_roots = roots

    def fwd(ctx, params, states, *parent_values, final_logits=False):
        seq_vals = parent_values[:n_seq]
        static_vals = parent_values[n_seq:n_seq + n_static]
        boot_vals = iter(parent_values[n_seq + n_static:])
        for v in seq_vals:
            enforce(isinstance(v, SequenceBatch),
                    "recurrent_group sequence inputs must be sequences")
        govern = seq_vals[0]
        b, t_len, length = govern.batch_size, govern.max_len, govern.length
        ref = govern.data
        dtype = ref.dtype if ref.is_floating_point() else torch.float32
        mask = govern.mask(dtype)
        carry = {m.name: _boot_value(
                     m, _raw_boot(next(boot_vals)) if bl is not None
                     else None, b, dtype, ref.device)
                 for m, bl in zip(mems, boot_layers)}
        static_feed = {ph.name: sv for ph, sv in zip(static_phs, static_vals)}
        states_c = dict(states)
        ys = [[None] * t_len for _ in inner_outs]
        for k in (range(t_len - 1, -1, -1) if reverse else range(t_len)):
            feed = dict(static_feed)
            feed.update({ph.name: v.data[:, k]
                         for ph, v in zip(seq_phs, seq_vals)})
            feed.update(carry)
            vals, states_c = evaluate(loop_roots,
                                      Context(ctx.is_train, ctx.seed),
                                      params, states_c, feed)
            mcol = mask[:, k, None]
            carry = {m.name: (mcol * _raw_boot(vals[tgt.name])
                              + (1.0 - mcol) * carry[m.name]
                              ).to(carry[m.name].dtype)
                     for m, tgt in zip(mems, link_targets)}
            for y, o in zip(ys, inner_outs):
                y[k] = _raw_boot(vals[o.name])
        stacked = {o.name: SequenceBatch(data=torch.stack(y, 1),
                                         length=length)
                   for o, y in zip(inner_outs, ys)}
        if sunk:
            # the sunk tail once over the stacked sequences (fc and mixed
            # act on [B, T, ...] as on each step)
            outer = dict(stacked)
            outer.update({ph.name: sv for ph, sv in zip(seq_phs, seq_vals)})
            remaining = list(sunk)
            while remaining:
                ready = [nd for nd in remaining
                         if all(p.name in outer for p in nd.parents)]
                enforce(ready, "recurrent_group sink: unresolvable tail "
                        "dependency")
                for nd in ready:
                    fn = (nd.attrs["__fc_logits__"]
                          if final_logits and nd is out else nd.fn)
                    outer[nd.name] = fn(
                        ctx, {s.name: params[s.name] for s in nd.param_specs},
                        {}, *(outer[p.name] for p in nd.parents))
                    remaining.remove(nd)
            # the group output carries the governing sequence's lengths
            result = outer[out.name]
            if isinstance(result, SequenceBatch):
                result = SequenceBatch(data=result.data, length=length)
        else:
            result = stacked[out.name]
        return (result, states_c) if state_specs else result

    # -- naming (≅ RecurrentLayerGroupBegin/End): in-group layers take the
    # "@<group>" suffix, the memories "<link>+delay1@<group>", auto-named
    # parameters follow their layer, and the group takes the step
    # output's name
    out_name = out.name
    for ph, outer in zip(seq_phs + static_phs, seq_inputs + static_inputs):
        ph.name = f"{outer.name}@{name}"
        ph.attrs["__in_group__"] = name
    for m in mems:
        link = m.attrs.get("link")
        m.name = f"{link}+delay1@{name}" if link else f"{m.name}@{name}"
        m.attrs["__in_group__"] = name
    for n in step_nodes:
        old = n.name
        n.name = f"{old}@{name}"
        n.attrs["__in_group__"] = name
        for s in n.param_specs:
            a = getattr(s, "attr", None)
            if (a is None or a.name is None) and s.name.startswith(f"_{old}."):
                # a frozen dataclass, renamed in place: the closures read
                # .name at call time
                object.__setattr__(
                    s, "name", f"_{n.name}." + s.name[len(old) + 2:])
        if (n.attrs.get("bias_spec") or "").startswith(f"_{old}."):
            n.attrs["bias_spec"] = (
                f"_{n.name}." + n.attrs["bias_spec"][len(old) + 2:])

    group = LayerOutput(
        name=out_name, layer_type="recurrent_layer_group", size=out.size,
        parents=parents, param_specs=param_specs, state_specs=state_specs,
        fn=fused_fwd if fused_fwd is not None else fwd,
        attrs={"reverse": reverse, "n_outputs": 1})
    if sunk and out.attrs.get("__fc_logits__") is not None:
        # the logits hook through the group: the same parents, the
        # pre-softmax logits of the sunk softmax fc
        group.attrs["__fc_logits__"] = (
            lambda ctx, params, states, *pv: fwd(ctx, params, states, *pv,
                                                 final_logits=True))
    return group


def gru_step_layer(input: LayerOutput, output_mem: LayerOutput,
                   size: int | None = None, act=None, gate_act=None,
                   name: str | None = None, bias_attr=None,
                   param_attr=None) -> LayerOutput:
    """One GRU step of a pre-projected input of size 3*D and the previous
    hidden state (≅ gru_step_layer / GruStepLayer), inside a
    recurrent_group step function; ``output_mem`` is the memory this
    layer's output feeds.  One recurrent weight [D, 3D] ([:, :2D] the
    gates, [:, 2D:] the candidate) and a [3D] bias."""
    from paddle_tpu_torch.layers import activation as act_mod
    from paddle_tpu_torch.layers.api import _wspec
    from paddle_tpu_torch.layers.attr import ParamAttr
    from paddle_tpu_torch.ops import rnn as rnn_ops

    size = size or input.size // 3
    name = name or gen_name("gru_step")
    w_spec = _wspec(param_attr, name, "w0", (size, 3 * size),
                    I.paddle_default())
    specs = [w_spec]
    bspec = None
    if bias_attr is not False:
        battr = bias_attr if isinstance(bias_attr, ParamAttr) else None
        bspec = _wspec(battr, name, "wbias", (3 * size,), I.constant(0.0))
        specs.append(bspec)
    ga = act_mod.get(gate_act) if gate_act else act_mod.SigmoidActivation()
    sa = act_mod.get(act) if act else act_mod.TanhActivation()

    def fwd(ctx, params, states, x, h):
        xw = _raw_boot(x)
        if bspec is not None:
            xw = xw + params[bspec.name]
        w = params[w_spec.name]
        return rnn_ops.gru_cell(xw, _raw_boot(h), w[:, :2 * size],
                                w[:, 2 * size:], ga, sa)

    return LayerOutput(name=name, layer_type="gru_step", size=size,
                       parents=(input, output_mem), param_specs=tuple(specs),
                       fn=fwd, attrs={"active_type": sa.name,
                                      "active_gate_type": ga.name,
                                      "bias_spec": bspec.name if bspec
                                      else None})
