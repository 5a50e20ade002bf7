"""The port's invariant linter (``repro_torch.analysis.lint``) against the
reference's: every rule fires on its bad fixture and stays quiet on the
clean twin, both linters agree finding for finding on the shared
fixtures, the baseline gates only new findings, and the port's source
gives the reference's findings on the reference's source, rule and symbol
for symbol."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis.lint import lint_file as j_lint_file
from repro.analysis.lint import lint_paths as j_lint_paths
from repro_torch.analysis import Finding as LazyFinding
from repro_torch.analysis import lint_paths as lazy_lint_paths
from repro_torch.analysis.lint import (RULE_NAMES, Finding, lint_file,
                                       lint_paths, load_baseline, main,
                                       write_baseline)

REPO = Path(__file__).resolve().parents[1]
BASELINE = REPO / "src/repro_torch/analysis/lint-baseline.json"

# one known-bad snippet per rule that needs no scoped path, and its clean
# twin; the two jit rules keep the reference's jax fixtures (the port has
# no jit, so they can find nothing in its own code)
CORPUS = {
    "mutable-default": """
        def enqueue(job, queue=[]):
            queue.append(job)
            return queue
    """,
    "future-swallow": """
        from concurrent.futures import Future

        def submit(work):
            fut = Future()
            try:
                work()
            except Exception:
                pass
            return fut
    """,
    "thread-not-daemon": """
        import threading

        def start():
            t = threading.Thread(target=print)
            t.start()
            return t
    """,
    "executor-leak": """
        from concurrent.futures import ThreadPoolExecutor

        def fanout(jobs):
            ex = ThreadPoolExecutor(4)
            return [ex.submit(j) for j in jobs]
    """,
    "jit-static-mutable": """
        import jax

        def compile_step(fn):
            return jax.jit(fn, static_argnames=["mode"])
    """,
    "jit-traced-branch": """
        import jax

        @jax.jit
        def step(x, threshold):
            if threshold > 0:
                return x * 2
            return x
    """,
    "host-sync-hot-loop": """
        import torch

        def decode(steps, logits):
            out = []
            for _ in range(steps):
                tok = torch.argmax(logits)
                out.append(tok.item())
            return out
    """,
}

CLEAN = {
    "mutable-default": """
        def enqueue(job, queue=None):
            queue = [] if queue is None else queue
            queue.append(job)
            return queue
    """,
    "future-swallow": """
        from concurrent.futures import Future

        def submit(work):
            fut = Future()
            try:
                work()
            except Exception as exc:
                fut.set_exception(exc)
            return fut
    """,
    "thread-not-daemon": """
        import threading

        def start():
            t = threading.Thread(target=print, daemon=True)
            t.start()
            return t
    """,
    "executor-leak": """
        from concurrent.futures import ThreadPoolExecutor

        def fanout(jobs):
            with ThreadPoolExecutor(4) as ex:
                return [f.result() for f in [ex.submit(j) for j in jobs]]
    """,
    "jit-static-mutable": """
        import jax

        def compile_step(fn):
            return jax.jit(fn, static_argnames=("mode",))
    """,
    "jit-traced-branch": """
        import jax
        import jax.numpy as jnp

        @jax.jit
        def step(x, threshold):
            return jnp.where(threshold > 0, x * 2, x)
    """,
    "host-sync-hot-loop": """
        import torch

        def decode(steps, logits):
            out = []
            for _ in range(steps):
                tok = torch.argmax(logits)
                out.append(tok)       # stays on the device
            return torch.stack(out).tolist()
    """,
}

# the torch pulls the rule reads besides the reference's float() /
# np.asarray / block_until_ready, and the reference's jnp producer
PULLS = {
    "item": "out.append(tok.item())",
    "cpu": "out.append(tok.cpu())",
    "tolist": "out.append(tok.tolist())",
    "float": "out.append(float(tok))",
    "asarray": "out.append(np.asarray(tok))",
}

LOOP = """
    import numpy as np
    import torch

    def decode(steps, logits):
        out = []
        for _ in range(steps):
            tok = torch.argmax(logits)
            {pull}
        return out
"""

JNP_LOOP = """
    import jax.numpy as jnp

    def decode(steps):
        out = []
        for _ in range(steps):
            tok = jnp.argmax(jnp.ones(4))
            out.append(int(tok))
        return out
"""

# the concurrency rules are scoped to distributed/ and serve/ paths
UNLOCKED_BAD = """
    import threading

    class Registry:
        def __init__(self):
            self._lock = threading.Lock()
            self._jobs = {}

        def put(self, k, v):
            self._jobs[k] = v

        def drop(self, k):
            self._jobs.pop(k, None)
"""

UNLOCKED_CLEAN = """
    import threading

    class Registry:
        def __init__(self):
            self._lock = threading.Lock()
            self._jobs = {}

        def put(self, k, v):
            with self._lock:
                self._jobs[k] = v

        def _drop(self, k):
            \"\"\"Caller holds the lock.\"\"\"
            self._jobs.pop(k, None)
"""

RAW_TELEMETRY_BAD = """
    class Service:
        def __init__(self):
            self.submits = 0
            self.served = {"fast": 0, "slow": 0}

        def submit(self, req, lane):
            self.submits += 1
            self.served[lane] += 1
"""

RAW_TELEMETRY_CLEAN = """
    from repro_torch.obs.metrics import MetricsRegistry

    class Service:
        def __init__(self):
            self.metrics = MetricsRegistry()
            self._c_submits = self.metrics.counter("submits", "requests")
            self._retries_left = 0          # internal state, not telemetry

        def submit(self, req):
            self._c_submits.inc()
            self._retries_left += 1
"""

PICKLE_BAD = """
    import pickle
    from pickle import loads

    def read_spec(raw):
        return pickle.loads(raw)

    class Handler:
        def on_frame(self, data):
            return loads(data)
"""

PICKLE_CLEAN = """
    import pickle

    def write_spec(obj):
        return pickle.dumps(obj)            # serializing is fine

    def read_spec(raw, loads):
        return loads(raw)                   # injected restricted loader
"""

SCOPED = [  # (rule, path, bad, clean, symbols the bad one names)
    ("unlocked-shared-write", "src/distributed/registry.py", UNLOCKED_BAD,
     UNLOCKED_CLEAN, {"Registry.put", "Registry.drop"}),
    ("raw-telemetry-dict", "src/serve/service.py", RAW_TELEMETRY_BAD,
     RAW_TELEMETRY_CLEAN, {"Service.submit"}),
    ("pickle-outside-codec", "src/serve/worker.py", PICKLE_BAD,
     PICKLE_CLEAN, {"read_spec", "Handler.on_frame"}),
]


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(text))
    return p


def _triples(findings):
    return [(f.rule, f.line, f.symbol) for f in findings]


@pytest.mark.parametrize("rule", sorted(CORPUS))
def test_rule_fires_on_bad_fixture(tmp_path, rule):
    findings = lint_file(_write(tmp_path, f"{rule}.py", CORPUS[rule]))
    assert [f.rule for f in findings] == [rule], findings


@pytest.mark.parametrize("rule", sorted(CLEAN))
def test_rule_quiet_on_clean_fixture(tmp_path, rule):
    findings = lint_file(_write(tmp_path, f"{rule}.py", CLEAN[rule]))
    assert findings == [], findings


@pytest.mark.parametrize("rule", sorted(set(CORPUS) - {"host-sync-hot-loop"}))
def test_findings_equal_the_reference_linters(tmp_path, rule):
    """On every fixture but the torch loop (which the reference's jnp-only
    rule cannot see) both linters give the same findings."""
    for name, text in ((f"bad_{rule}.py", CORPUS[rule]),
                       (f"ok_{rule}.py", CLEAN[rule])):
        p = _write(tmp_path, name, text)
        assert _triples(lint_file(p)) == _triples(j_lint_file(p))


@pytest.mark.parametrize("pull", sorted(PULLS))
def test_host_sync_reads_torch_producers_and_pulls(tmp_path, pull):
    p = _write(tmp_path, f"{pull}.py", LOOP.format(pull=PULLS[pull]))
    findings = lint_file(p)
    assert [(f.rule, f.symbol) for f in findings] == \
        [("host-sync-hot-loop", "decode")], findings
    assert "`tok` is computed on device" in findings[0].message
    assert j_lint_file(p) == []        # the reference's rule reads jnp only


def test_host_sync_still_reads_jnp_producers(tmp_path):
    p = _write(tmp_path, "jnp.py", JNP_LOOP)
    assert _triples(lint_file(p)) == _triples(j_lint_file(p)) != []


@pytest.mark.parametrize("rule,path,bad,clean,symbols", SCOPED,
                         ids=[c[0] for c in SCOPED])
def test_scoped_rules_fire_in_scope_only(tmp_path, rule, path, bad, clean,
                                         symbols):
    findings = lint_file(_write(tmp_path, path, bad))
    assert {f.rule for f in findings} == {rule}
    assert {f.symbol for f in findings} == symbols
    assert _triples(findings) == _triples(j_lint_file(tmp_path / path))
    assert lint_file(_write(tmp_path, "clean/" + path, clean)) == []
    # the same hazard outside distributed/ or serve/: not the rule's business
    assert lint_file(_write(tmp_path, "src/perfmodel/x.py", bad)) == []


def test_messages_name_the_ports_modules(tmp_path):
    tele = lint_file(_write(tmp_path, "src/serve/t.py", RAW_TELEMETRY_BAD))
    pick = lint_file(_write(tmp_path, "src/serve/p.py", PICKLE_BAD))
    assert all("repro_torch.obs.metrics Counter" in f.message for f in tele)
    assert all("repro_torch.serve.codec" in f.message for f in pick)
    assert tele and pick


def test_pickle_outside_codec_exempts_the_codec_itself(tmp_path):
    assert lint_file(_write(tmp_path, "src/serve/codec.py", PICKLE_BAD)) == []


def test_every_rule_has_a_fixture():
    assert set(RULE_NAMES) == set(CORPUS) | {c[0] for c in SCOPED}


def test_syntax_error_is_reported_not_raised(tmp_path):
    p = _write(tmp_path, "broken.py", "def broken(:\n")
    assert [f.rule for f in lint_file(p)] == ["syntax-error"]


# ---------------------------------------------------------------------------
# baseline workflow, CLI, the port's own source
# ---------------------------------------------------------------------------

def test_baseline_round_trip(tmp_path):
    findings = lint_file(_write(tmp_path, "a.py", CORPUS["mutable-default"]))
    bl = tmp_path / "baseline.json"
    write_baseline(bl, findings, {})
    accepted = load_baseline(bl)
    assert set(accepted) == {f.key for f in findings}
    # keys are line-free: shifting the code must not churn the baseline
    (tmp_path / "a.py").write_text(
        "# comment\n\n" + textwrap.dedent(CORPUS["mutable-default"]))
    assert {f.key for f in lint_file(tmp_path / "a.py")} == set(accepted)
    d = json.loads(bl.read_text())
    d["findings"][0]["justification"] = "intentional"
    bl.write_text(json.dumps(d))
    write_baseline(bl, findings, load_baseline(bl))
    assert load_baseline(bl)[findings[0].key] == "intentional"
    assert load_baseline(tmp_path / "missing.json") == {}


def test_cli_exit_codes(tmp_path, capsys):
    bad = _write(tmp_path, "bad.py", CORPUS["thread-not-daemon"])
    clean = _write(tmp_path, "ok.py", CLEAN["thread-not-daemon"])
    bl = tmp_path / "bl.json"
    assert main([str(clean)]) == 0
    assert main([str(bad)]) == 1                       # new finding
    assert main([str(bad), "--write-baseline", str(bl)]) == 0
    assert main([str(bad), "--baseline", str(bl)]) == 0   # accepted now
    assert main([str(clean), "--baseline", str(bl)]) == 0  # stale entry only
    capsys.readouterr()
    assert main([str(bad), "--json"]) == 1
    assert json.loads(capsys.readouterr().out)["new"][0]["rule"] == \
        "thread-not-daemon"


def test_port_is_clean_against_its_baseline():
    accepted = load_baseline(BASELINE)
    assert len(accepted) == 6 and all(accepted.values())
    new = [f for f in lint_paths([REPO / "src" / "repro_torch"])
           if f.key not in accepted]
    assert new == [], new


def test_port_findings_equal_the_reference_findings():
    """(rule, path, symbol) of the port's findings on src/repro_torch are
    the reference linter's on src/repro, with repro -> repro_torch."""
    port = {(f.rule, f.file, f.symbol)
            for f in lint_paths([REPO / "src" / "repro_torch"])}
    ref = {(f.rule, f.file.replace("src/repro/", "src/repro_torch/", 1),
            f.symbol) for f in j_lint_paths([REPO / "src" / "repro"])}
    assert port == ref
    assert port == set(load_baseline(BASELINE))


def test_cli_on_the_port_without_jax():
    code = ("import json, sys\n"
            "from repro_torch.analysis.lint import main\n"
            f"rc = main(['--baseline', {str(BASELINE)!r}])\n"
            "print(json.dumps([rc, sorted(m for m in sys.modules if m == 'jax'"
            " or m.startswith(('jax.', 'repro.')) or m == 'repro')]))")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    rc, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert rc == 0 and loaded == []
    assert "0 new finding(s), 6 total" in out.stdout


def test_lint_names_load_lazily_from_the_package():
    assert LazyFinding is Finding and lazy_lint_paths is lint_paths
    f = Finding("r", "src/x.py", 3, "C.m", "msg")
    assert f.key == ("r", "src/x.py", "C.m")
    assert str(f) == "src/x.py:3: [r] C.m: msg"
