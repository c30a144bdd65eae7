"""``repro_torch.core`` — the backend hooks of ``repro.core.ai``
(:mod:`.ai`): the ``Backend`` interface and the contextvars that bind the
ambient backend and dispatcher.  The PopPy compiler and runtime stay in
the reference package; a PopPy program reaches the port through a port
``Dispatcher`` or backend bound with the reference's ``use_dispatcher``
or ``use_backend``."""
