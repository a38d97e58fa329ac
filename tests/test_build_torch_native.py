"""The native host library (``native/libfusionhost.so``, git-ignored),
built through the port's loader before any test module reaches the JAX
package's loader.

pytest imports test modules in the order of their names, and every xdist
worker imports all of them before it runs a test; this module's name sorts
before every module that calls a native loader when it is imported
(checked below). The port's loader builds the library under a private name
and renames it into place. The JAX package's loader, which
``tests/test_depth_codec.py`` and ``tests/test_native.py`` call when they
are imported, runs ``make -C native`` in place when the file is missing and
keeps a failed load for the rest of its process: workers that collected at
once raced, one loaded another's half-written file, its JAX package fell
back to numpy, and every bit-for-bit comparison of the port with the JAX
package's native paths failed in that worker. Built here first, the file
is whole whenever the JAX loader looks for it.
"""

import ast
import pathlib

import pytest

from ros_gpu_depthmap_fusion_tpu_torch.utils import native as tnative

_NATIVE = tnative.available()

_LOADS = {"available", "require", "_load"}


def _loads_at_import(tree: ast.Module) -> bool:
    """Whether a module calls ``<...native...>.available()`` (or
    ``require`` / ``_load``) in code that runs when it is imported: its
    top-level statements, decorators and default arguments, but not the
    bodies of its functions."""
    todo = list(tree.body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            todo += node.decorator_list + node.args.defaults
            todo += [d for d in node.args.kw_defaults if d is not None]
            continue
        if isinstance(node, ast.Lambda):
            continue
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _LOADS
                and "native" in ast.unparse(node.func.value)):
            return True
        todo += list(ast.iter_child_nodes(node))
    return False


def test_sorts_before_the_modules_that_load_the_library():
    """Every other test module that loads the native library when it is
    imported is imported after this one."""
    here = pathlib.Path(__file__)
    loaders = [p.name for p in sorted(here.parent.glob("test_*.py"))
               if p != here and _loads_at_import(ast.parse(p.read_text()))]
    assert "test_depth_codec.py" in loaders and "test_native.py" in loaders
    assert all(here.name < name for name in loaders), loaders


def test_both_loaders_load_the_library():
    """The library the port's loader built loads through the JAX
    package's loader too, in this process."""
    if not _NATIVE:
        pytest.skip(f"native host library did not build: {tnative._error}")
    from ros_gpu_depthmap_fusion_tpu.utils import native as jnative
    assert jnative.available()
