"""A native-library cache of its own for each pytest process.

The JAX package builds its native libraries with g++ straight onto their
final path under ``PLAYAID_NATIVE_CACHE`` (``/tmp/playaid_native`` when
unset), which ``playaid_core_tpu/native.py`` and ``video/native_decoder.py``,
``native_encoder.py`` and ``native_remux.py`` read when they are imported.
Test workers (pytest-xdist) that share the directory race on an empty
cache: one can load a half-linked library and skip a whole test file.

pytest loads this file, at the root of the checkout, before
``tests/conftest.py`` and before any test module is imported, in the
controller and in every worker.  So each process gets a directory of its
own, named after its worker and its pid, even when it inherited the
variable from the controller; the directory is removed when the process
exits.
"""

import atexit
import os
import shutil
import tempfile

_worker = os.environ.get("PYTEST_XDIST_WORKER", "main")
os.environ["PLAYAID_NATIVE_CACHE"] = tempfile.mkdtemp(
    prefix=f"playaid_native_{_worker}_{os.getpid()}_")
atexit.register(shutil.rmtree, os.environ["PLAYAID_NATIVE_CACHE"], True)
