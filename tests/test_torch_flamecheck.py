"""flamecheck for the port (repro_torch.analysis) — the ports of
``tests/test_flamecheck.py``'s lock-discipline, host-sync and future-leak
cases, with torch fixtures for host-sync, the CLI contract, the port's tree
clean in strict mode, and the copied passes held to the JAX package's on
its own serving modules (the same findings, line for line).
"""
import os
import subprocess
import sys
import textwrap

import pytest

from repro.analysis import future_leak as j_future_leak
from repro.analysis import lock_discipline as j_lock_discipline
from repro.analysis.cli import default_paths as j_default_paths
from repro.analysis.common import ModuleSource as JModuleSource
from repro_torch.analysis import future_leak, lock_discipline
from repro_torch.analysis.cli import PASSES, default_paths, load_sources, \
    run_passes
from repro_torch.analysis.common import ModuleSource

SRC_ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


def _findings(tmp_path, name, code, passes=tuple(PASSES), strict=False):
    src = ModuleSource(str(tmp_path / name), code)
    return [f for f in run_passes([src], passes, strict=strict)]


def _active(findings):
    return [f for f in findings if not f.suppressed]


# ---------------------------------------------------------------------------
# pass 1: lock discipline
# ---------------------------------------------------------------------------

LOCK_FIXTURE = """
import threading

class Pool:
    def __init__(self):
        self._lock = threading.Lock()
        self._entries = {}
        self.bytes_used = 0

    def put(self, k, v):
        with self._lock:
            self._entries[k] = v
            self.bytes_used += 1

    def peek(self, k):
        return self._entries.get(k){pragma}
"""


def test_lock_unguarded_read_found(tmp_path):
    code = LOCK_FIXTURE.replace("{pragma}", "")
    fs = _active(_findings(tmp_path, "m.py", code,
                           passes=("lock-discipline",)))
    assert len(fs) == 1
    assert fs[0].code == "FC-LOCK"
    assert "_entries" in fs[0].message and "peek" in fs[0].message


def test_lock_pragma_suppresses(tmp_path):
    code = LOCK_FIXTURE.replace(
        "{pragma}",
        "  # flamecheck: unguarded-ok(read-only probe; stale OK)")
    fs = _findings(tmp_path, "m.py", code, passes=("lock-discipline",))
    assert len(fs) == 1 and fs[0].suppressed
    assert not _active(fs)


def test_lock_guarded_access_clean(tmp_path):
    code = textwrap.dedent("""
        import threading

        class Pool:
            def __init__(self):
                self._lock = threading.Lock()
                self._entries = {}

            def put(self, k, v):
                with self._lock:
                    self._entries[k] = v

            def get(self, k):
                with self._lock:
                    return self._entries.get(k)
        """)
    assert not _findings(tmp_path, "m.py", code,
                         passes=("lock-discipline",))


def test_lock_locked_by_caller_pragma(tmp_path):
    code = textwrap.dedent("""
        import threading

        class Pool:
            def __init__(self):
                self._lock = threading.Lock()
                self._entries = {}

            def put(self, k, v):
                with self._lock:
                    self._admit(k, v)

            def _admit(self, k, v):  # flamecheck: locked-by-caller(self._lock)
                self._entries[k] = v
        """)
    assert not _active(_findings(tmp_path, "m.py", code,
                                 passes=("lock-discipline",)))


def test_lock_condition_shares_wrapped_lock(tmp_path):
    """Condition(self._lock) and self._lock are one lock to the pass."""
    code = textwrap.dedent("""
        import threading

        class Q:
            def __init__(self):
                self._lock = threading.Lock()
                self._cv = threading.Condition(self._lock)
                self._items = []

            def put(self, x):
                with self._lock:
                    self._items.append(x)

            def drain(self):
                with self._cv:
                    return self._items.pop()
        """)
    assert not _findings(tmp_path, "m.py", code,
                         passes=("lock-discipline",))


def test_lock_admission_queue_cv_discipline(tmp_path):
    """The engine's _AdmissionQueue shape: two CVs wrapping one mutex.
    Holding either CV counts as holding the mutex; an access outside all
    three is flagged."""
    code = textwrap.dedent("""
        import heapq
        import threading

        class AdmissionQueue:
            def __init__(self):
                self._lock = threading.Lock()
                self._not_empty = threading.Condition(self._lock)
                self._not_full = threading.Condition(self._lock)
                self._heap = []
                self._live = 0

            def put(self, rec):
                with self._not_full:
                    heapq.heappush(self._heap, rec)
                    self._live += 1

            def get(self):
                with self._not_empty:
                    self._live -= 1
                    return heapq.heappop(self._heap)

            def shed_victim(self):
                with self._lock:
                    self._heap.sort()

            def qsize(self):
                return self._live
        """)
    fs = _active(_findings(tmp_path, "m.py", code,
                           passes=("lock-discipline",)))
    assert len(fs) == 1 and fs[0].code == "FC-LOCK"
    assert "qsize" in fs[0].message and "_live" in fs[0].message


def test_lock_alias_and_heappush_tracked(tmp_path):
    """cond aliasing + heapq first-arg mutation, the dso.py idioms."""
    code = textwrap.dedent("""
        import heapq
        import threading

        class Orch:
            def __init__(self):
                self._cond = {k: threading.Condition() for k in (1, 2)}
                self._pending = {k: [] for k in (1, 2)}

            def submit(self, k, item):
                cond = self._cond[k]
                with cond:
                    heapq.heappush(self._pending[k], item)

            def steal(self, k):
                return self._pending[k]
        """)
    fs = _active(_findings(tmp_path, "m.py", code,
                           passes=("lock-discipline",)))
    assert len(fs) == 1 and "steal" in fs[0].message


# ---------------------------------------------------------------------------
# pass 2: host sync in hot paths (torch's syncs)
# ---------------------------------------------------------------------------

SYNC_FIXTURE = """
import torch

class FlameEngine:
    def submit(self, req):
        return self._score(req)

    def _score(self, req):
        out = self._run(req)
        return out.cpu(){pragma}

def offline_tool(x):
    return x.cpu()    # NOT reachable from the hot path
"""


def test_host_sync_reachable_found(tmp_path):
    fs = _active(_findings(tmp_path, "m.py",
                           SYNC_FIXTURE.replace("{pragma}", ""),
                           passes=("host-sync",)))
    assert len(fs) == 1
    assert fs[0].code == "FC-SYNC-METHOD" and "_score" in fs[0].message


def test_host_sync_pragma_suppresses(tmp_path):
    code = SYNC_FIXTURE.replace(
        "{pragma}",
        "  # flamecheck: host-sync-ok(dispatch boundary: results to host)")
    assert not _active(_findings(tmp_path, "m.py", code,
                                 passes=("host-sync",)))


def test_host_sync_pragma_on_a_def_header_covers_nothing(tmp_path):
    """A host-sync pragma suppresses the statement it sits on only: on the
    header of the function around the sync it is reported unused, and the
    sync stays a finding."""
    code = SYNC_FIXTURE.replace("{pragma}", "").replace(
        "def _score(self, req):",
        "def _score(self, req):  # flamecheck: host-sync-ok(whole body)")
    fs = _findings(tmp_path, "m.py", code, passes=("host-sync",),
                   strict=True)
    assert sorted(f.code for f in _active(fs)) == [
        "FC-PRAGMA-UNUSED", "FC-SYNC-METHOD"]


def test_host_sync_detects_torch_syncs(tmp_path):
    """Each of torch's syncs, from the orchestrator's flush loop and the
    executor call: the methods that bring a tensor to the host, stream /
    event and device synchronizes, a scalar conversion of a tensor, and
    host->device staging; host numpy arithmetic is not flagged."""
    code = textwrap.dedent("""
        import numpy as np
        import torch

        class CoalescingOrchestrator:
            def _worker(self, ex):
                out = ex(self._args())
                torch.cuda.synchronize()
                self.stream.synchronize()
                a = out.item()
                b = out.tolist()
                c = out.numpy()
                return float(out.sum()), int(np.max(self._host)), a, b, c

        class Executor:
            def __call__(self, x, dev):
                t = torch.tensor(x, device=dev)
                u = torch.as_tensor(x)            # stays on the host
                return t.to(self.device), u.to("cuda:0"), u.cuda()
        """)
    fs = _active(_findings(tmp_path, "m.py", code, passes=("host-sync",)))
    got = sorted((f.code, f.line) for f in fs)
    assert {c for c, _ in got} == {"FC-SYNC-CUDA", "FC-SYNC-METHOD",
                                   "FC-SYNC-SCALAR", "FC-SYNC-PUT"}
    assert sum(c == "FC-SYNC-METHOD" for c, _ in got) == 4
    assert sum(c == "FC-SYNC-SCALAR" for c, _ in got) == 1
    assert sum(c == "FC-SYNC-PUT" for c, _ in got) == 4


def test_host_sync_unreachable_is_clean(tmp_path):
    code = textwrap.dedent("""
        class Offline:
            def report(self, t):
                return t.cpu().tolist(), t.item()
        """)
    assert not _findings(tmp_path, "m.py", code, passes=("host-sync",))


# ---------------------------------------------------------------------------

FUTURE_LEAK_FIXTURE = """
from repro_torch.serving.api import ResponseFuture

class Engine:
    def submit(self, request):
        fut = ResponseFuture(request){pragma}
        self.accepted += 1
        return None
"""


def test_future_leak_found(tmp_path):
    code = FUTURE_LEAK_FIXTURE.replace("{pragma}", "")
    fs = _active(_findings(tmp_path, "m.py", code,
                           passes=("future-leak",)))
    assert len(fs) == 1 and fs[0].code == "FC-FUTURE"
    assert "'fut'" in fs[0].message and "submit" in fs[0].message


def test_future_leak_pragma_suppresses(tmp_path):
    code = FUTURE_LEAK_FIXTURE.replace(
        "{pragma}", "  # flamecheck: future-ok(fixture builds a dead one)")
    fs = _findings(tmp_path, "m.py", code, passes=("future-leak",))
    assert len(fs) == 1 and fs[0].suppressed
    assert not _active(fs)


def test_future_bare_drop_found(tmp_path):
    code = textwrap.dedent("""
        from repro_torch.serving.api import ResponseFuture

        def probe(request):
            ResponseFuture(request)
        """)
    fs = _active(_findings(tmp_path, "m.py", code,
                           passes=("future-leak",)))
    assert len(fs) == 1 and fs[0].code == "FC-FUTURE"
    assert "dropped" in fs[0].message


def test_future_discharged_forms_clean(tmp_path):
    """Every legitimate way out of the obligation: resolve it, return it,
    hand it to a call (positionally, by keyword, inside a tuple), store it
    into shared state, or resolve it from a nested closure."""
    code = textwrap.dedent("""
        from repro_torch.serving.api import ResponseFuture

        class Engine:
            def resolved(self, request):
                fut = ResponseFuture(request)
                fut.set_exception(RuntimeError("shed"))

            def returned(self, request):
                fut = ResponseFuture(request)
                return fut

            def handed_positional(self, request):
                fut = ResponseFuture(request)
                self._register(fut)

            def handed_keyword(self, request):
                fut = ResponseFuture(request)
                self._record(key=(1, 2), fut=fut)

            def stored(self, request):
                fut = ResponseFuture(request)
                self._futs[id(request)] = fut

            def closure_resolves(self, request):
                fut = ResponseFuture(request)

                def on_timeout():
                    fut.set_exception(TimeoutError())
                self._watchdog.append(on_timeout)
        """)
    assert not _active(_findings(tmp_path, "m.py", code,
                                 passes=("future-leak",)))


# ---------------------------------------------------------------------------
# pragma hygiene (--strict), the CLI contract, the port's tree
# ---------------------------------------------------------------------------

def test_strict_flags_unused_pragma_and_empty_reason(tmp_path):
    code = textwrap.dedent("""
        X = 1  # flamecheck: unguarded-ok(nothing here needs a lock)
        Y = 2  # flamecheck: host-sync-ok()
        """)
    fs = _findings(tmp_path, "m.py", code, strict=True)
    codes = sorted(f.code for f in fs)
    assert codes == ["FC-PRAGMA-REASON", "FC-PRAGMA-UNUSED",
                     "FC-PRAGMA-UNUSED"]


def _run_cli(args, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, env=env, cwd=str(cwd))


def test_cli_exit_codes(tmp_path):
    clean = tmp_path / "clean.py"
    clean.write_text("def f():\n    return 1\n")
    bad = tmp_path / "m.py"
    bad.write_text(LOCK_FIXTURE.replace("{pragma}", ""))
    assert _run_cli(["--strict", str(clean)], tmp_path).returncode == 0
    r = _run_cli(["--strict", str(bad)], tmp_path)
    assert r.returncode == 1
    assert "FC-LOCK" in r.stdout
    assert _run_cli(["--passes", "recompile", str(clean)],
                    tmp_path).returncode == 2


def test_cli_json_output(tmp_path):
    import json
    bad = tmp_path / "m.py"
    bad.write_text(LOCK_FIXTURE.replace("{pragma}", ""))
    r = _run_cli(["--json", str(bad)], tmp_path)
    assert r.returncode == 1
    data = json.loads(r.stdout)
    assert len(data) == 1 and data[0]["code"] == "FC-LOCK"


def test_repo_is_baseline_clean():
    """The port's serving, core and kernel-wrapper modules stay
    flamecheck-clean in strict mode: every sync they reach carries a
    pragma with its reason, and no pragma is stale."""
    paths = default_paths()
    assert any(p.endswith(os.path.join("repro_torch", "serving",
                                       "engine.py")) for p in paths)
    assert all(os.sep + "repro_torch" + os.sep in p for p in paths)
    active = _active(run_passes(load_sources(paths), strict=True))
    assert not active, "\n".join(f.format() for f in active)


@pytest.mark.parametrize("name,ours,theirs", [
    ("lock-discipline", lock_discipline.run, j_lock_discipline.run),
    ("future-leak", future_leak.run, j_future_leak.run)])
def test_copied_passes_match_the_jax_package(tmp_path, name, ours, theirs):
    """The copied passes find what the JAX package's find, on its own
    serving modules and on the leaking fixtures above (before pragmas)."""
    paths = j_default_paths()
    for i, code in enumerate((LOCK_FIXTURE.replace("{pragma}", ""),
                              FUTURE_LEAK_FIXTURE.replace("{pragma}", ""))):
        (tmp_path / f"fixture{i}.py").write_text(code)
        paths.append(str(tmp_path / f"fixture{i}.py"))
    mine = ours([ModuleSource.load(p) for p in paths])
    ref = theirs([JModuleSource.load(p) for p in paths])
    key = lambda f: (f.path, f.line, f.code, f.message)  # noqa: E731
    assert sorted(map(key, mine)) == sorted(map(key, ref))
    assert ref, f"{name}: no finding to compare"
