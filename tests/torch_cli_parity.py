"""Helpers of the command-line parity tests (``tests/test_torch_cli*.py``).

:func:`run_both` runs ``pde_tpu.cli.main`` (under the suite's x64) and
``pde_tpu_torch.cli.main`` with ``--device cpu`` under torch's default
dtype set to float64, on one argv, in one go: both read ``date.today()``
for their market data.  :class:`Runs` runs each named argv once a module;
:func:`assert_close` walks two parsed JSON outputs.
"""

import contextlib
import io
import json
import os

import numpy as np
import torch

from pde_tpu import cli as ref_cli
from pde_tpu_torch import cli as port_cli


@contextlib.contextmanager
def float64_default():
    """torch's default dtype set to float64, restored on exit."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


def run(main, argv):
    """``main(argv)``'s exit code and standard output."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(list(argv))
    return rc, buf.getvalue()


def run_both(argv, workdir=None):
    """((reference rc, stdout), (port rc, stdout)); the port on the CPU in
    float64.  With ``workdir``, each runs in a folder of its own there
    (``ref``, ``port``): the trading system opens its sqlite file, and a
    cache path names a file, in the working directory."""
    out = []
    for name, main, extra in (("ref", ref_cli.main, []),
                              ("port", port_cli.main, ["--device", "cpu"])):
        cwd = os.getcwd()
        if workdir is not None:
            os.makedirs(os.path.join(workdir, name), exist_ok=True)
            os.chdir(os.path.join(workdir, name))
        try:
            with float64_default() if name == "port" else contextlib.nullcontext():
                out.append(run(main, extra + list(argv)))
        finally:
            os.chdir(cwd)
    return tuple(out)


class Runs:
    """Each named argv run by both packages once, on first use, in
    ``workdir/<name>/{ref,port}``."""

    def __init__(self, argvs, workdir):
        self.argvs = argvs
        self.workdir = str(workdir)
        self._out = {}

    def __getitem__(self, name):
        if name not in self._out:
            self._out[name] = run_both(self.argvs[name], os.path.join(self.workdir, name))
        return self._out[name]

    def json(self, name):
        """Both exit codes checked to be 0, both outputs parsed."""
        (ref_rc, ref), (port_rc, port) = self[name]
        assert ref_rc == 0 and port_rc == 0, (ref_rc, port_rc)
        return json.loads(port), json.loads(ref)


def assert_close(port, ref, rtol, atol=0.0, gates=None, path=""):
    """``port`` equal to ``ref`` in structure, strings, flags and integers,
    and every float within ``rtol``/``atol`` (``gates`` maps a key to its
    own ``(rtol, atol)`` for that key's subtree)."""
    gates = gates or {}
    if isinstance(ref, dict):
        assert isinstance(port, dict) and set(port) == set(ref), (path, set(port) ^ set(ref))
        for k in ref:
            r, a = gates.get(k, (rtol, atol))
            assert_close(port[k], ref[k], r, a, gates, f"{path}.{k}")
    elif isinstance(ref, list):
        assert isinstance(port, list) and len(port) == len(ref), path
        for i, (p, q) in enumerate(zip(port, ref)):
            assert_close(p, q, rtol, atol, gates, f"{path}[{i}]")
    elif isinstance(ref, float) and not isinstance(ref, bool):
        np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol, err_msg=path)
    else:
        assert type(port) is type(ref) and port == ref, (path, port, ref)
