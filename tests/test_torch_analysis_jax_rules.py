"""The port's readings of graftlint's eight JAX-only rules
(``tpu_sgd_torch/analysis``: shape-trap, eager-in-loop, donation-safety,
host-sync, obs-discipline, callback-discipline, carry-stability,
memo-key) held against the JAX package's rules on its fixtures.

Each fixture of ``tests/test_analysis.py`` that lints with one of those
rules has a torch spelling here (``TWINS``): the same situation written
for PyTorch and CUDA graphs, call for call.  The JAX test runs with a
recording ``lint``; the k-th module set it lints goes through the JAX
rules, the k-th twin through the port's rules of the same names, and the
``(rule, path, line)`` sets must be equal (a JAX fixture that is silent
has a silent twin).  The JAX test's own assertions hold too.

Port-only cases pin what has no JAX fixture: the port's cache idioms for
memo-key, the capture vocabulary, mutations of the port's real modules
(the twins of the JAX package's mutation tests), and the seeded module
on which every one of the thirteen rules fires.
"""

import importlib.util
import os
import textwrap

import pytest

from tpu_sgd_torch.analysis import core as pcore
from tpu_sgd_torch.analysis.rules_callback import CallbackDisciplineRule
from tpu_sgd_torch.analysis.rules_carry import CarryStabilityRule
from tpu_sgd_torch.analysis.rules_donation import DonationSafetyRule
from tpu_sgd_torch.analysis.rules_failpoint import FailpointCoverageRule
from tpu_sgd_torch.analysis.rules_memo import MemoKeyRule
from tpu_sgd_torch.analysis.rules_shape import EagerInLoopRule, ShapeTrapRule
from tpu_sgd_torch.analysis.rules_sync import HostSyncRule, ObsDisciplineRule

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the rules whose torch readings are twinned here
JAX_ONLY = ("shape-trap", "eager-in-loop", "donation-safety", "host-sync",
            "obs-discipline", "callback-discipline", "carry-stability",
            "memo-key")


def tmod(src, relpath="fixture_mod.py"):
    return pcore.ModuleFile("/fixtures/" + relpath, relpath,
                            textwrap.dedent(src))


def _plint(modules, rules, **cfg):
    cfg.setdefault("root", "/fixtures")
    if isinstance(modules, pcore.ModuleFile):
        modules = [modules]
    return pcore.run_lint(config=pcore.Config(**cfg), rules=rules,
                          modules=modules)


def _found(result):
    return sorted((f.rule, f.path, f.line) for f in result.findings
                  if f.rule in JAX_ONLY)


# -- the torch spellings of the JAX fixtures --------------------------------

SHAPE_TWINS = {
    "test_shape_trap_fires_on_eager_pad_and_concatenate": ["""
        import torch
        step = torch.compile(torch.sigmoid)
        def host_assemble(X, tail):
            Xp = torch.nn.functional.pad(X.cuda(), (0, 0, 0, tail))
            return step(torch.cat([Xp, Xp]))
    """],
    "test_shape_trap_fires_on_dynamic_slice_of_device_array": ["""
        import torch
        step = torch.compile(torch.sigmoid)
        def score(X, w, n):
            out = torch.matmul(X.cuda(), w)
            return step(out[:n])
    """],
    "test_shape_trap_silent_inside_jit_and_on_numpy": ["""
        import functools
        import torch
        import torch.nn.functional as F
        import numpy as np

        @torch.compile
        def traced_pad(X):
            return F.pad(X, (0, 0, 0, 1))

        @functools.partial(torch.compile, dynamic=False)
        def traced_cat(X, k):
            def inner(A):
                return torch.cat([A, A])
            return inner(X)[:k]

        def wrapped(X):
            return torch.cat([X, X])

        apply_wrapped = torch.compile(wrapped)

        def host_numpy(X, n):
            Xp = np.pad(X, ((0, 3), (0, 0)))
            return apply_wrapped(np.concatenate([Xp, Xp])[:n])

        def eager_only(X, n):
            # eager torch compiles nothing: a ragged cat feeding eager
            # code is one kernel at any size
            Xc = X.cuda()
            return torch.cat([Xc, Xc])[:n].sum()

        def captured(X, g):
            with torch.cuda.graph(g):
                out = torch.cat([X, X])
            return out
    """],
    "test_shape_trap_silent_on_helper_called_from_traced_fn": ["""
        import torch

        def helper(X):
            return torch.cat([X, X])

        @torch.compile
        def body(X):
            return helper(X)
    """],
    "test_shape_trap_ignores_lax_dynamic_slice": ["""
        import torch
        step = torch.compile(torch.sigmoid)

        def window(X, k, B):
            return step(torch.narrow(X.cuda(), 0, k * B, B))
    """],
    "test_eager_in_loop_fires_on_jit_constructed_per_iteration": ["""
        import torch
        from functools import partial

        def run(fs, X):
            outs = []
            for f in fs:
                outs.append(torch.compile(f)(X))
            while X.sum() < 0:
                g = partial(torch.compile, dynamic=False)(fs[0])
            return outs
    """],
    "test_eager_in_loop_silent_on_hoisted_and_memoized": ["""
        import functools
        import torch

        @functools.lru_cache(maxsize=None)
        def _program(B):
            return torch.compile(lambda X: X * B)

        compiled = torch.compile(lambda X: X + 1)

        def run(chunks):
            return [_program(c.shape[0])(c) for c in chunks]

        def loop_defines_fn(chunks):
            for c in chunks:
                # the graph lives in a def only CALLED later, not built here
                def build():
                    return torch.cuda.CUDAGraph()
                yield build
    """],
}

DONATION_TWINS = {
    "test_donation_safety_fires_on_read_after_donate": ["""
        import torch



        def build(g, x):
            with torch.cuda.graph(g):
                out = x * 2
            g.replay()
            kept = out
            g.replay()
            return kept.sum() + out.sum()
    """],
    "test_donation_safety_silent_on_rebind_idiom": ["""
        import torch

        def build(g, x, n):
            with torch.cuda.graph(g):
                out = x * 2
            total = 0
            for _ in range(n):
                g.replay()
                kept = out
                total = total + kept.sum()
            copied = out.clone()
            g.replay()
            return total + copied.sum()
    """],
    "test_donation_safety_resolves_cross_module_imports": [[
        ("""
        import torch

        def step(g):
            g.replay()
    """, "provider.py"),
        ("""
        import torch; from provider import step
        def build(g, x):
            g.capture_begin(); out = x * 2; g.capture_end(); kept = out
            step(g)
            return kept.sum()
    """, "consumer.py")]],
    "test_donation_forwarder_one_call_level": ["""
        import torch



        def acc(g):
            g.replay()

        def helper(g, x):
            return acc(g)
        def use(g, x):
            g.capture_begin(); out = x * 2; g.capture_end(); kept = out
            helper(g, x)
            tail = kept.sum()
            return out, tail
    """],
    "test_donation_forwarder_voided_by_param_rebind": ["""
        import torch

        def acc(g):
            g.replay()

        def safe_helper(g, x):
            g = torch.cuda.CUDAGraph()  # a fresh graph, not the caller's
            return acc(g)

        def use(g, x):
            g.capture_begin(); out = x * 2; g.capture_end(); kept = out
            safe_helper(g, x)
            tail = kept.sum()
            return out, tail
    """],
}

SYNC_TWINS = {
    "test_host_sync_fires_on_scalar_coercions_in_loop": ["""
        import torch

        step = torch.compile(lambda w: w * 2)

        def drive(w, n):
            hist = []
            for _ in range(n):
                w = step(w)
                hist.append(float(w))
            return hist
    """],
    "test_host_sync_fires_on_implicit_bool_and_while_test": ["""
        import torch

        step = torch.compile(lambda w: w)

        def poll(w):
            flag = step(w)
            while flag:
                flag = step(flag)
    """],
    "test_host_sync_fires_on_comparison_bool_test": ["""
        import torch

        step = torch.compile(lambda w: w)

        def poll(w, n):
            for _ in range(n):
                w = step(w)
                if w > 0:
                    break

        def drain(c):
            c = step(c)
            while c > 0:
                c = step(c)
    """, """
        import torch

        step = torch.compile(lambda w: w)

        def drive(w, n):
            for _ in range(n):
                w = step(w)
                c = int(w)  # graftlint: disable=host-sync -- one sanctioned fetch
                if c > 0:
                    break
    """],
    "test_host_sync_interprocedural_flags_loop_borne_call_site": ["""
        import torch
        import numpy as np

        step = torch.compile(lambda w: w * 2)

        def fetch(v):
            return v.cpu()

        def drive(w, n):
            for _ in range(n):
                w = step(w)
                fetch(w)
    """],
    "test_host_sync_silent_on_boundary_fetch_and_traced_loops": ["""
        import torch
        import numpy as np

        step = torch.compile(lambda w: w * 2)

        def drive(w, n):
            for _ in range(n):
                w = step(w)
            return float(w)

        def bulk(w, n):
            ys = step(w)
            for _ in range(n):
                w = step(w)
            return tuple(a.cpu() for a in (w, ys))

        @torch.compile
        def traced(w):
            for _ in range(3):
                w = torch.sin(w)
            return w

        def host_numpy(rows, n):
            out = []
            for r in rows:
                out.append(np.asarray(r))
            return out

        def captured(w, g):
            with torch.cuda.graph(g):
                for _ in range(3):
                    w = step(w)
            return w
    """],
    "test_host_sync_silent_on_for_iterable_and_else_clause": ["""
        import torch
        import numpy as np

        count = torch.compile(lambda w: w.sum())

        def once(w, rows):
            n = count(w)
            for i in range(int(n)):
                rows.append(i)
            else:
                tail = float(n)
            return tail

        def per_trip(w, rows):
            n = count(w)
            for _ in rows:
                k = int(n)
            return k

        def per_outer_trip(w, grids):
            n = count(w)
            for g in grids:
                for i in range(int(n)):
                    g.append(i)
    """],
}

CALLBACK_TWINS = {
    "test_callback_unordered_consumed_result_and_leaky_target": ["""
        import torch

        HIST = []


        def bad_cb(x):
            HIST.append(x)
            return x

        def body(x, g):
            with torch.cuda.graph(g): r = bad_cb(x)
            return r
    """],
    "test_callback_clean_site_passes": ["""
        import numpy as np
        import torch

        class Keeper:
            def on_window(self, start, ws):
                self.last = ws * 2
                return start + 1

        def build(keeper, g):
            def fire(start, ws):
                with torch.cuda.graph(g):
                    out = keeper.on_window(start, ws)
                return out
            return fire
    """],
    "test_callback_fire_and_forget_unordered_is_fine": ["""
        import torch

        def tick(x):
            return x.add_(1)

        def body(x, g):
            with torch.cuda.graph(g):
                tick(x)
            print(x)  # outside the capture: runs every call
            return x
    """],
    "test_callback_reraising_handler_is_still_leaky": ["""
        import torch

        def cb(x):
            try:
                return x * 2
            except BaseException:
                print("capture failed")
                raise
        def body(x, g):
            with torch.cuda.graph(g): r = cb(x)
            return r
    """],
    "test_callback_target_resolution_survives_name_collision": [
        [("""
        import torch

        class Keeper:
            def on_window(self, x):
                print(x); return x

        def build(keeper, g):
            def fire(x):
                with torch.cuda.graph(g): return keeper.on_window(x)

            return fire
    """, "caller_mod.py")],
        [("caller", "caller_mod.py"), ("""
        class Widget:
            def on_window(self, event):
                return event
    """, "other_mod.py")],
        [("""
        import torch

        def build(hooks, g):
            def fire(x):
                with torch.cuda.graph(g): return hooks.on_window(x)
            return fire
    """, "remote_caller.py"), ("other", "other_mod.py"), ("""
        class Panel:
            def on_window(self, event):
                return event
    """, "other2_mod.py")]],
}

CARRY_TWINS = {
    "test_carry_fires_on_python_scalar_init": ["""
        import torch


        def run(w, g):
            i = 0
            while i < 3:
                with torch.cuda.graph(g):
                    w.mul_(i)
                i += 1
    """],
    "test_carry_fires_on_scalar_reset_in_body": ["""
        import torch


        def run(n, w, g):
            for x in range(n):
                with torch.cuda.graph(g): w.add_(x)
    """],
    "test_carry_silent_on_pinned_init_and_device_reset": ["""
        import torch

        def run(xs, w, g):
            step = torch.zeros((), dtype=torch.int64, device=w.device)
            with torch.cuda.graph(g):
                w.add_(step)
                step.add_(1)
            for x in xs:
                g.replay()

        def local_scan_helper_does_not_fire(scan, data):
            return scan(lambda c, x: (0, c), 0, data)
    """],
    "test_carry_silent_on_non_jax_lax_lookalikes": ["""
        import contextlib
        import flax

        def run(w, n, g):
            for i in range(n):
                with contextlib.nullcontext():
                    w = w * i
                with flax.cuda.graph(g):
                    w = w * i
            return w
    """, """
        import torch
        from tpu_sgd_torch.ops import cuda_kernels as ck

        def run(w, xs, g):
            for k, x in enumerate(xs):
                with ck.captured_launches(): w.mul_(k)
                with torch.cuda.graph(g): w.add_(x * k)
    """],
    "test_carry_fires_on_keyword_init_and_body": ["""
        import torch


        def kw_init(w, n, g):
            for x in range(n): g.capture_begin(); w.add_(x); g.capture_end()

        def kw_body_reset(w, xs, g):
            lr = 1.0
            for x in xs:  # a tensor of xs is no host number: silent
                with torch.cuda.graph(g, pool=None): w.add_(lr)
                lr = lr * 0.5

        def kw_while(w, g):
            t = 0
            while t < 3:
                with torch.cuda.graph(g): w.mul_(t)
                t = t + 1
    """],
}

MEMO_TWINS = {
    "test_memo_local_alias_store_attaches_to_declared_cache": ["""
        import torch

        GRAFTLINT_MEMO = {"Engine._cache": ("size",)}

        class Engine:
            def __init__(self, size):
                self._cache = {}
                self.size = size

            def program_for(self):
                cache = self._cache
                key = (self.size,)
                fn = cache.get(key)
                if fn is None:
                    fn = torch.compile(lambda x: x * self.size)
                    cache[key] = fn
                return fn
    """],
    "test_memo_undeclared_program_cache_is_a_finding": ["""
        import torch

        _CACHE = {}

        def program_for(key):
            fn = _CACHE.get(key)
            if fn is None:
                fn = torch.cuda.CUDAGraph()
                _CACHE[key] = fn
            return fn
    """],
    "test_memo_declared_cache_with_complete_key_passes": ["""
        import torch

        _CACHE = {}
        GRAFTLINT_MEMO = {"_CACHE": ("key", "lr")}

        def program_for(key, lr):
            fn = _CACHE.get((key, lr))
            if fn is None:
                fn = torch.compile(lambda w: w * lr)
                _CACHE[(key, lr)] = fn
            return fn
    """],
    "test_memo_factory_read_outside_key_is_a_finding": ["""
        import torch

        _CACHE = {}
        GRAFTLINT_MEMO = {"_CACHE": ("k",)}

        def program_for(k, lr):
            fn = torch.compile(lambda w: w * lr)
            _CACHE[k] = fn
            return fn
    """],
}

#: the seeded module of ``test_every_rule_fires_on_its_seeded_violation``
#: in torch: lines 1-49 (the lock, cond and contract seeds) are the JAX
#: package's, lines 50-92 the torch seeds on the same lines
_SEEDED_TAIL = '''
def acc(g):
    g.replay()


step = torch.compile(lambda w: w * 2)

def host(X, g, n):
    Xp = step(F.pad(X.cuda(), (0, 0, 0, n))); g.capture_begin(); out = X * 2; g.capture_end(); kept = out
    acc(g)
    use_after = kept.sum()
    for _ in range(2):
        f = torch.compile(lambda a: a)
    return Xp, out, use_after, f

def drive(w, n):
    hist = []
    for _ in range(n):
        w = step(w)
        hist.append(float(w))
    return hist

def leaky_cb(x):
    HIST.append(x)
    return x

def resident(w, g):
    i = 0
    while i < 3:
        g.capture_begin(); r = leaky_cb(w); g.capture_end()
        i += 1
        g.capture_begin(); w.mul_(i); g.capture_end()

def program_for(k, lr):
    fn = _PROGRAMS.get(k)
    if fn is None:
        fn = torch.compile(lambda w: w * lr)
        _PROGRAMS[k] = fn
    return fn

def traced_tick(w):
    out = step(w)
    event("train.tick", loss=out)
    return out
'''

_SEEDED_HEAD = '''
import threading
import torch
import torch.nn.functional as F
import numpy as np
from tpu_sgd_torch.ops import cuda_kernels as ck
import contextlib
from functools import partial
from tpu_sgd_torch.obs.spans import event
'''


def _seeded_torch_source():
    """The JAX seeded module's lines 10-49, between the torch head and
    tail."""
    src = open(os.path.join(ROOT, "tests", "test_analysis.py")).read()
    i = src.index('    seeded = mod("""')
    j = src.index('""", relpath="seeded.py")')
    jax_lines = textwrap.dedent(src[i + len('    seeded = mod("""'):j]) \
        .splitlines()
    head = _SEEDED_HEAD.splitlines()
    assert len(head) == 9
    return "\n".join(head + jax_lines[9:49] + _SEEDED_TAIL.splitlines()[1:])


SEEDED_TWINS = {
    "test_every_rule_fires_on_its_seeded_violation": [
        [(_seeded_torch_source, "seeded.py")]],
}

TWINS = {**SHAPE_TWINS, **DONATION_TWINS, **SYNC_TWINS, **CALLBACK_TWINS,
         **CARRY_TWINS, **MEMO_TWINS, **SEEDED_TWINS}

#: port rule class per rule name
PORT_RULES = {
    "shape-trap": ShapeTrapRule, "eager-in-loop": EagerInLoopRule,
    "donation-safety": DonationSafetyRule, "host-sync": HostSyncRule,
    "obs-discipline": ObsDisciplineRule,
    "callback-discipline": CallbackDisciplineRule,
    "carry-stability": CarryStabilityRule, "memo-key": MemoKeyRule,
}


def _twin_modules(spec, previous):
    """A twin entry as ``ModuleFile``s: a source string, or a list of
    ``(source, relpath)`` where a source may name a module of an earlier
    call by its first word (``"caller"``) or be a callable."""
    if isinstance(spec, str):
        return [tmod(spec)]
    if isinstance(spec, tuple):
        spec = [spec]
    out = []
    for src, rel in spec:
        if callable(src):
            out.append(pcore.ModuleFile("/fixtures/" + rel, rel, src()))
        elif "\n" not in src:
            out.append(previous[rel])
        else:
            out.append(tmod(src, rel))
    return out


def _reference():
    spec = importlib.util.spec_from_file_location(
        "_graftlint_twin_reference",
        os.path.join(ROOT, "tests", "test_analysis.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def reference_tests():
    return _reference()


def _port_rules(jax_rules):
    out = []
    for r in jax_rules:
        if r.name in PORT_RULES:
            out.append(PORT_RULES[r.name]())
        elif r.name == "failpoint-coverage":
            out.append(FailpointCoverageRule(
                registry=r._registry_override,
                registry_path=r._registry_path_override))
        else:
            from tpu_sgd_torch.analysis.core import default_rules
            out.extend(p for p in default_rules() if p.name == r.name)
    return out


@pytest.mark.parametrize("case", sorted(TWINS))
def test_port_rules_agree_with_the_jax_rules_on_torch_twins(
        reference_tests, monkeypatch, case):
    calls = []
    jlint = reference_tests.lint

    def recording(modules, rules, **cfg):
        res = jlint(modules, rules, **cfg)
        calls.append((rules, dict(cfg), _found(res)))
        return res

    monkeypatch.setattr(reference_tests, "lint", recording)
    getattr(reference_tests, case)()  # its own assertions hold too
    twins = TWINS[case]
    assert len(calls) == len(twins), (case, len(calls))
    previous = {}
    for (rules, cfg, want), spec in zip(calls, twins):
        mods = _twin_modules(spec, previous)
        previous.update({m.relpath: m for m in mods})
        got = _found(_plint(mods, _port_rules(rules), **cfg))
        assert sorted(set(got)) == sorted(set(want)), (case, got, want)


# -- port-only cases ----------------------------------------------------------

def test_every_rule_fires_on_the_torch_seeded_module():
    """The torch seeded module (the JAX seeds' lines 10-49 and the torch
    seeds on lines 50-92): each of the thirteen port rules reports its
    planted bug."""
    seeded = pcore.ModuleFile("/fixtures/seeded.py", "seeded.py",
                              _seeded_torch_source())
    rules = [FailpointCoverageRule(registry={"io.feed": "seeded.py"})
             if r.name == "failpoint-coverage" else r
             for r in pcore.default_rules()]
    fired = {f.rule for f in _plint([seeded], rules).findings}
    assert set(pcore.KNOWN_RULES) <= fired, set(pcore.KNOWN_RULES) - fired


def test_memo_single_slot_and_shape_key_stores():
    """The port's cache idioms are store sites: ``self._c = (key, run)``
    (checked for drift and factory coverage) and ``SHAPES.add(key)`` on a
    declared set; an ``lru_cache`` factory keys on all its arguments and
    needs no declaration."""
    ok = tmod("""
        import functools
        import torch
        from factories import make_run

        GRAFTLINT_MEMO = {"Opt._run_cache": ("gradient", "config"),
                          "_SHAPES": ("rows", "d")}
        _SHAPES = set()

        @functools.lru_cache(maxsize=None)
        def plan(d):
            return torch.compile(lambda x: x[:d])

        class Opt:
            def cached(self, gradient):
                key = (gradient, self.config)
                entry = self._run_cache
                if entry is not None and entry[0] == key:
                    return entry[1]
                run = make_run(gradient, self.config)
                self._run_cache = (key, run)
                return run

        def score(rows, d):
            _SHAPES.add((rows, d))
    """)
    assert _found(_plint(ok, [MemoKeyRule()])) == []
    bad = tmod("""
        import torch
        from factories import make_run
        GRAFTLINT_MEMO = {"Opt._run_cache": ("gradient",)}

        class Opt:
            def cached(self, gradient):
                key = (gradient,)
                entry = self._run_cache
                if entry is not None and entry[0] == key:
                    return entry[1]
                run = make_run(gradient, self.config)
                self._run_cache = (key, run)
                return run
    """)
    found = _plint(bad, [MemoKeyRule()]).findings
    assert [(f.line, "`config`" in f.message) for f in found] == [(13, True)]


def test_memo_undeclared_library_cache_is_a_finding():
    res = _plint(tmod("""
        import ctypes

        _loaded = {}

        def load(name):
            lib = _loaded.get(name)
            if lib is None:
                lib = ctypes.CDLL(name + ".so")
                _loaded[name] = lib
            return lib
    """), [MemoKeyRule()])
    assert _found(res) == [("memo-key", "fixture_mod.py", 10)]


def test_torch_vocabulary_is_matched_through_imports():
    """Only torch's names are torch's: ``re.compile`` in a loop builds no
    program, ``json.load`` loads no library, ``.to(torch.float32)`` moves
    nothing to the card; ``torch.cuda.synchronize()`` and an event's
    ``synchronize()`` in a host loop of a card-holding function stall."""
    res = _plint(tmod("""
        import json
        import re
        import torch

        def quiet(paths, x):
            w = x.to(torch.float32)
            for p in paths:
                pat = re.compile(p)
                doc = json.load(open(p))
                if w.sum() > 0:
                    pass
            return pat, doc

        def stalls(x, n):
            w = x.cuda()
            ev = torch.cuda.Event()
            for _ in range(n):
                w = w * 2
                torch.cuda.synchronize()
                ev.synchronize()
            return w
    """), [EagerInLoopRule(), HostSyncRule()])
    assert _found(res) == [("host-sync", "fixture_mod.py", 20),
                           ("host-sync", "fixture_mod.py", 21)]


def test_obs_discipline_reads_the_ports_obs_modules():
    res = _plint(tmod("""
        from tpu_sgd_torch.obs import counters
        from tpu_sgd_torch.obs.spans import span

        def tick(x):
            w = x.cuda()
            counters.inc("train.tick", nbytes=w.sum())
            loss = float(w.sum())  # the one fetch, then a host value
            with span("train.step", loss=loss) as sp:
                sp.set(norm=w.norm())
    """), [ObsDisciplineRule()])
    assert _found(res) == [("obs-discipline", "fixture_mod.py", 7),
                           ("obs-discipline", "fixture_mod.py", 10)]


def _port_module(relpath, mutate=None):
    src = open(os.path.join(ROOT, relpath)).read()
    if mutate is not None:
        new = mutate(src)
        assert new != src, f"mutation anchor not found in {relpath}"
        src = new
    return pcore.ModuleFile(os.path.join(ROOT, relpath), relpath, src)


def test_mutation_deleted_run_cache_key_field_fails_lint():
    """Delete ``mesh`` from ``GradientDescent._run_cache``'s declaration:
    memo-key's drift check catches it (the port's twin of the JAX
    package's ``test_mutation_deleted_memo_key_field_fails_lint``)."""
    gd = "tpu_sgd_torch/optimize/gradient_descent.py"
    assert _found(_plint([_port_module(gd)], [MemoKeyRule()])) == []
    mutated = _port_module(gd, lambda s: s.replace(
        '"gradient", "updater", "config", "mesh", "X",',
        '"gradient", "updater", "config", "X",', 1))
    found = _plint([mutated], [MemoKeyRule()]).findings
    assert any("'mesh'" in f.message and "does not list it" in f.message
               for f in found)


def test_mutation_item_in_the_ports_observed_loop_fails_lint():
    """Insert an ``.item()`` on the step's result in the port's observed
    streamed loop, just before its per-step barrier: host-sync catches
    the new per-iteration read (the twin of the JAX package's
    ``test_mutation_item_in_resident_loop_body_fails_lint``)."""
    streamed = "tpu_sgd_torch/optimize/streamed.py"
    gd = _port_module("tpu_sgd_torch/optimize/gradient_descent.py")
    assert _found(_plint([_port_module(streamed), gd],
                         [HostSyncRule()])) == []
    barrier = ("                    # graftlint: disable=host-sync -- "
               "observed driver: a per-step barrier is its contract\n"
               "                    torch.cuda.synchronize(new_w.device)")
    mutated = _port_module(streamed, lambda s: s.replace(
        barrier, "                    probe = new_w.item()\n" + barrier, 1))
    found = _plint([mutated, gd], [HostSyncRule()]).findings
    assert any(".item()" in f.message for f in found)


def test_mutation_host_effect_in_the_ports_capture_fails_lint():
    """Put a host call inside ``_BlockRunner._capture``'s capture region:
    callback-discipline flags it (it would run once at capture, never on
    replay; the twin of the JAX package's
    ``test_mutation_unguarded_resident_callback_fails_lint``)."""
    gd = "tpu_sgd_torch/optimize/gradient_descent.py"
    assert _found(_plint([_port_module(gd)],
                         [CallbackDisciplineRule()])) == []
    anchor = ("            with torch.cuda.graph(graph):\n"
              "                self.block(")
    mutated = _port_module(gd, lambda s: s.replace(
        anchor, "            with torch.cuda.graph(graph):\n"
                "                print('captured')\n"
                "                self.block(", 1))
    found = _plint([mutated], [CallbackDisciplineRule()]).findings
    assert len(found) == 1 and "`print`" in found[0].message


def test_the_port_lints_clean_with_all_thirteen_rules():
    """The port's lint over ``PORT_INCLUDE`` in process: no finding, the
    thirteen rules of ``KNOWN_RULES``, every suppression with a reason,
    and the suppressions of the eight JAX-only rules on the lines where
    those rules really fire (a stale one would be a finding)."""
    cfg = pcore.load_config(ROOT)
    res = pcore.run_lint(config=cfg)
    assert res.findings == [], "\n".join(str(f) for f in res.findings)
    assert res.rules == list(pcore.KNOWN_RULES)
    mods = pcore.load_modules(cfg)
    assert all(s.reason for m in mods for s in m.suppressions)
    assert res.suppressed > 0


#: JAX public names whose port counterpart is named for PyTorch
RENAMED = {
    ("dataflow.py", "SYNC_JAX"): "SYNC_TORCH",
    ("dataflow.py", "jax_prefixes"): "module_prefixes",
    ("rules_callback.py", "CALLBACK_NAMES"): "EFFECT_OBS",
    ("rules_carry.py", "LOOP_SIGS"): "LOOP_KINDS",
    ("rules_carry.py", "LOOP_KWARGS"): "LOOP_KINDS",
}


def _public_names(path, reexports=False):
    import ast

    out = set()
    for n in ast.parse(open(path).read()).body:
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, ast.Assign):
            out.update(t.id for t in n.targets if isinstance(t, ast.Name))
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out.add(n.target.id)
        elif isinstance(n, ast.ImportFrom) and reexports:
            out.update(a.asname or a.name for a in n.names)
    return {x for x in out if not x.startswith("_")}


def test_every_jax_analysis_module_has_a_port_counterpart():
    """Each ``tpu_sgd/analysis/*.py`` has a module of the same name in the
    port with the JAX module's public names (``RENAMED`` lists the five
    named for PyTorch: JAX's sync calls, its import prefixes (the port
    maps every import, ``tracing.module_prefixes``), its callback
    primitives and its ``lax`` loop signatures)."""
    jdir = os.path.join(ROOT, "tpu_sgd", "analysis")
    pdir = os.path.join(ROOT, "tpu_sgd_torch", "analysis")
    for name in sorted(os.listdir(jdir)):
        if not name.endswith(".py"):
            continue
        port = os.path.join(pdir, name)
        assert os.path.exists(port), name
        have = _public_names(port, reexports=True)
        for public in sorted(_public_names(os.path.join(jdir, name))):
            assert RENAMED.get((name, public), public) in have, (name,
                                                                 public)
