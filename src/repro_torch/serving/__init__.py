from .engine import PageAllocator, Request, ServingEngine  # noqa: F401
from .prefix_cache import PagedPrefixCache  # noqa: F401
from .sampler import sample_tokens  # noqa: F401
from .tokenizer import ByteTokenizer  # noqa: F401
