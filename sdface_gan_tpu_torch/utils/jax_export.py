"""Archives exported from the JAX package's orbax checkpoints, and their
optimizer states in the port's form.

``scripts/export_jax_checkpoint.py`` (run where JAX is installed) writes one
``.npz`` per orbax checkpoint of a JAX run: each leaf under its tree path
joined by ``/`` (list indices as digits), ``None`` leaves left out, python
scalars as 0-d arrays, bfloat16 leaves as their ``uint16`` bits named in
the JSON string ``__dtypes__``.  :func:`read_export` turns an archive back
into the nested tree: dicts, lists (a missing index is ``None``), numpy
leaves, and ``torch.bfloat16`` tensors for the bfloat16 leaves.

The optimizer states, both exact:

* optax ``adam`` (a chain, ``[{count, mu, nu}]``) -> ``torch.optim.Adam``
  state: ``exp_avg`` / ``exp_avg_sq`` are ``mu`` / ``nu`` taken through the
  parameters' own converter (``utils/convert.py``, a pure permutation of
  layout) and ``step`` is ``count``;
* the JAX package's ``ranger`` (``{inner: [gc, [{count, mu, nu}]], slow,
  step}``) -> the port's ``Ranger`` state ``{step, mu, nu, slow}``.

The state is keyed by the port optimizer's own parameter order, and the
``param_groups`` are that optimizer's: lr and betas (those adjusted for
lazy regularisation too) are hyperparameters of the port's optimizers, not
state.  A moment of a JAX leaf that is no parameter of the port's optimizer
(the decoder's noise inputs, buffers here, whose gradients are zero because
training draws fresh noise) is dropped, and must be zero.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict

import numpy as np
import torch
from torch import nn

DTYPES_KEY = "__dtypes__"


def read_export(path: str) -> Dict[str, Any]:
    """An exported archive -> the nested tree it was written from."""
    tree: Dict[str, Any] = {}
    with np.load(path, allow_pickle=False) as z:
        if DTYPES_KEY not in z.files:
            raise ValueError(f"{path} is not an export of scripts/export_jax_checkpoint.py "
                             f"(no {DTYPES_KEY})")
        dtypes = json.loads(z[DTYPES_KEY].item())
        for key in z.files:
            if key == DTYPES_KEY:
                continue
            leaf: Any = z[key]
            if dtypes.get(key) == "bfloat16":
                leaf = torch.from_numpy(leaf.view(np.int16)).view(torch.bfloat16)
            node = tree
            *parents, last = key.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[last] = leaf
    return _with_lists(tree)


def export_keys(path: str) -> set:
    """The top-level keys of an exported archive's tree (its data unread)."""
    with np.load(path, allow_pickle=False) as z:
        return {k.split("/")[0] for k in z.files if k != DTYPES_KEY}


def _with_lists(node: Any) -> Any:
    """Dicts keyed by digits only become lists, ``None`` where an index is missing."""
    if not isinstance(node, dict):
        return node
    node = {k: _with_lists(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        out = [None] * (max(map(int, node)) + 1)
        for k, v in node.items():
            out[int(k)] = v
        return out
    return node


def _map_leaves(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(fn, v) for v in tree]
    return None if tree is None else fn(tree)


def convert(converter: Callable, tree: Any, *args) -> Dict[str, torch.Tensor]:
    """``converter(tree, *args)`` (one of ``utils/convert.py``) on a tree that
    may hold bfloat16 tensors: they cross as their 16 bits (the converters
    only permute layouts) and come back as bfloat16."""
    bits = _map_leaves(lambda x: x.view(torch.int16).numpy() if torch.is_tensor(x) else x,
                       tree)
    return {k: v.view(torch.bfloat16) if v.dtype == torch.int16 else v
            for k, v in converter(bits, *args).items()}


def fill_like(moments: Any, params: Any) -> Any:
    """``moments`` with every leaf it lacks (``None``: a leaf that an optax
    mask left out) set to zeros shaped as ``params``'s."""
    if isinstance(params, dict):
        have = moments if isinstance(moments, dict) else {}
        return {k: fill_like(have.get(k), v) for k, v in params.items()}
    if isinstance(params, list):
        have = moments if isinstance(moments, list) else []
        return [fill_like(have[i] if i < len(have) else None, v) for i, v in enumerate(params)]
    if moments is not None:
        return moments
    return torch.zeros_like(params) if torch.is_tensor(params) else np.zeros_like(params)


def _port_state(opt: torch.optim.Optimizer, module: nn.Module, step,
                tensors: Dict[str, Dict[str, torch.Tensor]], what: str) -> Dict[str, Any]:
    """``opt.state_dict()`` with each parameter's state ``{"step": step,
    name: tensors[name][param name], ...}``; a tensor of a leaf that is no
    parameter of ``opt`` must be zero."""
    names = {id(p): n for n, p in module.named_parameters()}
    trained = set()
    for group in opt.param_groups:
        for p in group["params"]:
            n = names[id(p)]
            lacking = [k for k, sd in tensors.items() if n not in sd]
            if lacking:
                raise KeyError(f"{what}: the JAX optimizer state has no {lacking} for {n}")
            for k, sd in tensors.items():
                if tuple(sd[n].shape) != tuple(p.shape):
                    raise ValueError(f"{what}: {k} of {n} is {tuple(sd[n].shape)}, the "
                                     f"parameter {tuple(p.shape)}")
            # one step tensor per parameter: Adam increments it in place
            opt.state[p] = {"step": step.clone() if torch.is_tensor(step) else step,
                            **{k: sd[n] for k, sd in tensors.items()}}
            trained.add(n)
    for k, sd in tensors.items():
        for n, v in sd.items():
            if n not in trained and bool(v.float().any()):
                raise ValueError(f"{what}: {k} of {n}, which the port does not train as a "
                                 "parameter, is not zero")
    return opt.state_dict()


def adam_state(opt: torch.optim.Adam, module: nn.Module, adam: Dict[str, Any],
               to_state_dict: Callable[[Any], Dict[str, torch.Tensor]],
               what: str) -> Dict[str, Any]:
    """The state dict of ``opt`` (the port's Adam over ``module``'s
    parameters, built as the port's training builds it) holding optax's
    ``{count, mu, nu}``; ``to_state_dict`` converts a tree shaped as the
    parameters (use :func:`convert`)."""
    step = torch.tensor(float(np.asarray(adam["count"])), dtype=torch.float32)
    return _port_state(opt, module, step, {"exp_avg": to_state_dict(adam["mu"]),
                                           "exp_avg_sq": to_state_dict(adam["nu"])}, what)


def ranger_state(opt: torch.optim.Optimizer, module: nn.Module, ranger: Dict[str, Any],
                 to_state_dict: Callable[[Any], Dict[str, torch.Tensor]],
                 what: str) -> Dict[str, Any]:
    """The state dict of ``opt`` (the port's ``Ranger``) holding the JAX
    ``ranger`` state: RAdam's ``mu`` / ``nu``, lookahead's slow weights and
    step (RAdam's count must equal it: both count the updates)."""
    radam = ranger["inner"][1][0]
    step = int(np.asarray(ranger["step"]))
    if int(np.asarray(radam["count"])) != step:
        raise ValueError(f"{what}: RAdam's count {int(np.asarray(radam['count']))} is not "
                         f"lookahead's step {step}")
    return _port_state(opt, module, step, {"mu": to_state_dict(radam["mu"]),
                                           "nu": to_state_dict(radam["nu"]),
                                           "slow": to_state_dict(ranger["slow"])}, what)
