"""Keep the port's tests that reach ``torch._dynamo`` working after a test
file has put module stubs into ``sys.modules``.

``tests/reference_loader.py:83-92`` (``_install_stubs``) puts a
``mock.MagicMock`` into ``sys.modules`` for each reference-script import that
is absent here (``onnx``, ``onnxruntime``, ``soundfile``, ``librosa``, …), and
``load_reference`` installs them before it reads the (absent) reference file.
A mock has no ``__spec__``, so ``importlib.util.find_spec("onnx")`` raises
``ValueError: onnx.__spec__ is not set``.  ``import torch._dynamo`` calls
``find_spec`` on its third-party skip list (``onnx`` among it), so in an
xdist worker that ran ``tests/test_reference_parity.py`` or
``tests/test_dfsmn_aec.py`` first, ``torch.export``, ``torch.library.opcheck``
and ``FlopCounterMode`` could not start.

The loader predates the port and stays as it is (the port's rule: no file
that was in the repository before it changes), so the repair lives here: a
module fixture takes the stub entries out of ``sys.modules`` while a port
test module runs, from its first fixture to its last test, so ``find_spec``
sees those packages as absent (they are), and puts them back afterwards for
the reference-loader tests.  Only the stub entries move: restoring a copy of
the whole of ``sys.modules`` (``mock.patch.dict``) would also unload every
module imported in between, ``torch._dynamo`` with it.

A test module uses it by importing the fixture::

    from torch_isolation import hide_module_stubs  # noqa: F401
"""
from __future__ import annotations

import contextlib
import sys
from unittest import mock

import pytest

__all__ = ["module_stubs", "stubs_hidden", "hide_module_stubs"]


def module_stubs() -> dict:
    """The ``sys.modules`` entries that are mocks, by name."""
    return {name: m for name, m in list(sys.modules.items())
            if isinstance(m, mock.NonCallableMock)}


@contextlib.contextmanager
def stubs_hidden():
    """``sys.modules`` without its mock entries inside; each one put back
    afterwards unless a real module has taken its name meanwhile."""
    stubs = module_stubs()
    for name in stubs:
        del sys.modules[name]
    try:
        yield stubs
    finally:
        for name, m in stubs.items():
            sys.modules.setdefault(name, m)


@pytest.fixture(autouse=True, scope="module")
def hide_module_stubs():
    """:func:`stubs_hidden` for the whole of the module that imports this
    fixture: module-scoped and autouse, it is set up before the module's
    other fixtures and torn down after its last test."""
    with stubs_hidden():
        yield
