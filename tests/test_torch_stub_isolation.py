"""The guard of ``tests/torch_isolation.py``: the reference loader's module
stubs (``tests/reference_loader.py``'s ``_install_stubs``) no longer stop
``torch._dynamo`` from importing in the same process.

The witness runs without the guard and must fail as it failed in a shared
test worker (``ValueError: onnx.__spec__ is not set``); the same script with
the guard must export a one-operator module and leave the stubs in place
afterwards.  Each runs in a fresh interpreter, since a process that has
imported ``torch._dynamo`` once never runs its import again.
"""
import os
import subprocess
import sys
from pathlib import Path

from torch_isolation import hide_module_stubs  # noqa: F401

TESTS = Path(__file__).resolve().parent

SCRIPT = """
import contextlib, sys
from reference_loader import load_reference
try:
    load_reference("no/such/Export_Script.py")
except FileNotFoundError:
    pass
assert type(sys.modules["onnx"]).__name__ == "MagicMock"
guard = {guard}
if guard:
    from torch_isolation import stubs_hidden
    scope = stubs_hidden()
else:
    scope = contextlib.nullcontext()
with scope:
    import torch
    import torch._dynamo

    class One(torch.nn.Module):
        def forward(self, x):
            return x.sin()

    ep = torch.export.export(One(), (torch.ones(3),), strict=False)
    ops = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert ops == ["aten.sin.default"], ops
assert type(sys.modules["onnx"]).__name__ == "MagicMock"
print("exported", ops)
"""


def _run(guard: bool) -> subprocess.Popen:
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(TESTS), str(TESTS.parent)])}
    return subprocess.Popen([sys.executable, "-c", SCRIPT.format(guard=guard)], cwd=TESTS,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_stubbed_onnx_does_not_break_dynamo():
    witness, guarded = _run(False), _run(True)  # side by side
    w_out, w_err = witness.communicate(timeout=300)
    g_out, g_err = guarded.communicate(timeout=300)
    assert witness.returncode != 0, w_out
    assert "onnx.__spec__ is not set" in w_err, w_err[-2000:]
    assert guarded.returncode == 0, g_err[-4000:]
    assert "exported ['aten.sin.default']" in g_out
