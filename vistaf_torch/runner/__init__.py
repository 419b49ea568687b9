"""Session runner, CLI and the artifact/file contract (JAX ``runner/``)."""

from vistaf_torch.runner import io  # noqa: F401
from vistaf_torch.runner import session  # noqa: F401
