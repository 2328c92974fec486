"""Build a test module's costly reference once per pytest session.

Under pytest-xdist every worker that draws a test of a module builds that
module's fixtures again.  ``once_per_session`` keeps the first worker's
result in a pickle under the session's shared base temporary directory,
behind a ``FileLock`` (pytest-xdist's documented pattern): the other
workers read it, or wait while it is being built.  Without xdist
(``PYTEST_XDIST_WORKER`` unset) it simply builds, and ``filelock`` is not
needed.
"""

import os
import pickle


def once_per_session(tmp_path_factory, name, build):
    """``build()``'s result (picklable), computed by one worker."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return build()
    from filelock import FileLock

    path = tmp_path_factory.getbasetemp().parent / f"{name}.pkl"
    with FileLock(str(path) + ".lock"):
        if path.is_file():
            return pickle.loads(path.read_bytes())
        out = build()
        path.write_bytes(pickle.dumps(out))
    return out
