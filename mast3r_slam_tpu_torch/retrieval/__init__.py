"""Loop-closure retrieval: the ASMK head, codebook and inverted file."""

from .asmk import ASMKSettings  # noqa: F401
from .database import RetrievalDatabase  # noqa: F401
from .head import RetrievalHeadSettings  # noqa: F401
