"""Both packages' operator tools side by side, for the port's tests: the
JAX package's root ``tools/<name>.py`` and its port
``ncnet_tpu_torch.tools.<name>``, and one way to compare what they give."""

import importlib
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")


def jax_tool(name):
    """The root tool ``tools/<name>.py`` (it imports the JAX package)."""
    if TOOLS not in sys.path:
        sys.path.insert(0, TOOLS)
    return importlib.import_module(name)


def port_tool(name):
    """The port's ``ncnet_tpu_torch.tools.<name>``."""
    return importlib.import_module(f"ncnet_tpu_torch.tools.{name}")


def canon(doc) -> str:
    """A document as sorted JSON: NaN equals NaN, tuples equal lists."""
    return json.dumps(doc, sort_keys=True, default=repr)


def same(a, b) -> bool:
    return canon(a) == canon(b)


def both(tool, fn, *args, **kw):
    """``fn`` of the JAX tool and of its port on the same arguments: the
    answers must be the same; returns the JAX tool's."""
    want = getattr(jax_tool(tool), fn)(*args, **kw)
    got = getattr(port_tool(tool), fn)(*args, **kw)
    assert canon(got) == canon(want), (tool, fn)
    return want


def both_main(tool, argv):
    """Both tools' ``main(argv)``: the same exit code, which it returns."""
    rc = jax_tool(tool).main(list(argv))
    assert port_tool(tool).main(list(argv)) == rc, (tool, argv)
    return rc


def without_ages(doc):
    """A verdict with its wall-clock readings dropped (each tool fetched
    a live document at its own instant)."""
    if isinstance(doc, dict):
        return {k: without_ages(v) for k, v in doc.items()
                if not k.endswith("age_s")}
    if isinstance(doc, list):
        return [without_ages(v) for v in doc]
    return doc


def both_judge_url(url, **kw):
    """``stall_watchdog.judge_url`` of both tools on one live plane: the
    same verdict but for the ages; returns the JAX tool's."""
    want = jax_tool("stall_watchdog").judge_url(url, **kw)
    got = port_tool("stall_watchdog").judge_url(url, **kw)
    assert canon(without_ages(got)) == canon(without_ages(want)), url
    return want
