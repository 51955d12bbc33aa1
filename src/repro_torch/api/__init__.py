"""Public serving API of the port (``TrainSession`` waits for the paper's
loop, ROADMAP.md Queue 1 item 3; the fused train steps are in
``repro_torch.core.spmd``).

    from repro_torch.api import ServeSession
    session = ServeSession(cfg, params, tau=2.0, slots=8, max_len=161)
    session.submit(prompt_tokens, decode_tokens=32); results = session.run()
"""
from repro_torch.api.serve_session import (ServeResult, ServeSession,  # noqa: F401
                                           ServeStats, resolve_serve_boundary,
                                           sequential_reference,
                                           sequential_sticky_reference,
                                           serve_step_config)
