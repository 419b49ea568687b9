"""plainref: a frozen copy of the plain paths of the PyTorch port, the
benchmark's reference.

Copied from ``vistaf_torch`` at commit 98381829b5ef1b546fde2f6549f168989515a1b3
(the modules that ``ftp.pipeline``, ``temperature.inference``,
``pipelines.force``, ``pipelines.multimodal`` and ``calib.scalar_models``
import), with the package renamed and three changes: every kernel wrapper
takes its plain PyTorch version on every device (``kernels.route``), no
forward replays a CUDA graph (``graph_route`` is False, so the loops and
branches run as plain ``while`` / ``if`` with the predicate read on the
host), and ``use_full_fp32`` leaves the matmul precision to the caller.
It imports torch and numpy only: nothing of the program under test.
"""

__version__ = "0.1.0"


def use_full_fp32() -> None:
    """The caller sets the matmul precision (``reference/refrun.py``)."""
