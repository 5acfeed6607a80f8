"""What the benchmark hands the program and reads back from it during
set-up, through PyTorch's global module and optimizer hooks and its CUDA
graphs' replay, so that it needs no hook inside the program:

- the initial weights: the first train-mode forward of each target model
  (found by its parameters' names and shapes) copies the weights the
  benchmark made from the seed into it, before its optimizer has any
  state;
- the first train steps of each followed target: after its first
  optimizer step the first gradient as the optimizer holds it (AdamW's
  first moment over (1 - beta1)), and after each of its first ``steps``
  steps its weights, whether the step ran eagerly (the optimizer's hook)
  or as a replay of a captured CUDA graph (the replay's wrapper, which
  reads the weights back after each replay that changed them);
- of the observed target, the batch each eager forward saw and its
  logits, and at its first forward the outputs of the submodules named by
  ``watch`` (relations whose outputs reach no logit);
- at the end of epoch 0, the weights of every target.

A CUDA graph capture runs a step's host code once more without running
it: the hooks skip it.  Every hook, and the replay's wrapper, is removed
before the measured window opens.
"""

from __future__ import annotations

import torch
import torch.nn.modules.module as module_hooks
import torch.optim.optimizer as optim_hooks


def _capturing() -> bool:
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def _signature(named) -> tuple:
    return tuple(sorted((n, tuple(p.shape)) for n, p in named))


def _clone(params: dict) -> dict:
    return {n: p.detach().clone() for n, p in params.items()}


class Probe:
    """``weights``: {target: {name: tensor}}, the benchmark's initial
    weights by the port's parameter names; ``observe``: the target whose
    logits are read; ``followed``: the targets whose steps are read
    (default: ``observe`` alone); ``steps``: how many; ``watch``: name
    prefixes of the observed target's submodules whose outputs are read
    at its first forward."""

    def __init__(self, weights: dict, observe: str, steps: int = 3,
                 followed: tuple = (), watch: tuple = ()):
        self.weights = weights
        self.observe = observe
        self.followed = tuple(followed) or (observe,)
        self.max_steps = steps
        self.watch = tuple(watch)
        self.sigs = {_signature(w.items()): name
                     for name, w in weights.items()}
        self.modules: dict[str, torch.nn.Module] = {}
        self._seen: dict[int, str | None] = {}
        self._watched: dict[int, str] = {}
        self.batches: list = []      # the observed eager steps' inputs
        self.logits: list = []       # ... and outputs
        self.parts: dict = {}        # watched outputs at the first forward
        # {target: [weights after each step]}, {target: first gradient}
        self.after_step: dict = {t: [] for t in self.followed}
        self.first_grad: dict = {}
        self.at_first_step: dict = {}      # other targets' weights then
        self.after_epoch0: dict = {}       # {target: weights}
        self.epoch0_loss: float | None = None
        self._handles = [
            module_hooks.register_module_forward_pre_hook(self._pre),
            module_hooks.register_module_forward_hook(self._post),
            optim_hooks.register_optimizer_step_post_hook(self._stepped)]
        self._replay = None
        if torch.cuda.is_available():
            graph_cls = torch.cuda.CUDAGraph
            self._replay = graph_cls.replay
            original, probe = self._replay, self

            def replay(graph, *args, **kwargs):
                out = original(graph, *args, **kwargs)
                probe._replayed()
                return out
            graph_cls.replay = replay

    def _target(self, module) -> str | None:
        key = id(module)
        if key not in self._seen:
            self._seen[key] = self.sigs.get(
                _signature(module.named_parameters()))
        return self._seen[key]

    def _pre(self, module, args):
        name = self._target(module)
        if name is None or not module.training or _capturing():
            return
        if name not in self.modules:
            self.modules[name] = module
            with torch.no_grad():
                for n, p in module.named_parameters():
                    p.copy_(self.weights[name][n])
            if name == self.observe and self.watch:
                self._watched = {id(m): n for n, m in module.named_modules()
                                 if n.startswith(self.watch)}
        if name == self.observe and not self.logits:
            # The other targets' weights as the observed model's first
            # step finds them (the SCN's, once clustering has ended).
            self.at_first_step = {
                t: _clone(dict(m.named_parameters()))
                for t, m in self.modules.items() if t != name}

    def _post(self, module, args, output):
        if _capturing() or not module.training:
            return
        part = self._watched.get(id(module))
        if part is not None:
            if not self.logits and part not in self.parts:
                self.parts[part] = output.detach().clone()
            return
        if (self._target(module) != self.observe
                or len(self.logits) >= self.max_steps):
            return
        self.batches.append(args[0])
        self.logits.append(output.detach().clone())

    def _stepped(self, optimizer, args, kwargs):
        if _capturing():
            return
        ids = {id(p) for g in optimizer.param_groups for p in g["params"]}
        for t in self.followed:
            model = self.modules.get(t)
            if model is None:
                continue
            params = dict(model.named_parameters())
            if ids != {id(p) for p in params.values()}:
                continue
            steps = self.after_step[t]
            if not steps:
                beta1 = optimizer.param_groups[0]["betas"][0]
                self.first_grad[t] = {
                    n: optimizer.state[p]["exp_avg"].detach() / (1 - beta1)
                    for n, p in params.items()}
            if len(steps) < self.max_steps:
                steps.append(_clone(params))

    def _replayed(self) -> None:
        """After a replay: a followed target that has taken its first
        step, and whose weights the replay changed, took its next one."""
        pending = [t for t in self.followed if t in self.modules
                   and 1 <= len(self.after_step[t]) < self.max_steps]
        if not pending:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        for t in pending:
            params = dict(self.modules[t].named_parameters())
            last = self.after_step[t][-1]
            if any(not torch.equal(p, last[n]) for n, p in params.items()):
                self.after_step[t].append(_clone(params))

    def epoch_end(self, epoch: int, loss: float) -> None:
        """At each epoch's end: epoch 0's loss and weights."""
        if epoch == 0:
            self.epoch0_loss = float(loss)
            self.after_epoch0 = {t: _clone(dict(m.named_parameters()))
                                 for t, m in self.modules.items()}

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []
        if self._replay is not None:
            torch.cuda.CUDAGraph.replay = self._replay
            self._replay = None
