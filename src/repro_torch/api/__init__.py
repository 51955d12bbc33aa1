"""Public training and serving API of the port (counterpart of
``repro/api``).

    from repro_torch.api import TrainSession, ServeSession
    session = TrainSession.from_config(model, splitee_cfg, opt_cfg,
                                       client_data, batch_size=64)
    session.train(rounds=100)
    serve = ServeSession(cfg, params, tau=2.0, slots=8, max_len=161)
    serve.submit(prompt_tokens, decode_tokens=32); results = serve.run()

``TrainSession`` runs the paper's loop on the reference engine, the fused
cohort engine or the spmd engine (the fused round body over the ranks of a
``torch.distributed`` world), over fixed client shards or a client
population (``repro_torch.population``),
and saves and restores checkpoints in the JAX package's format;
``ServeSession.restore`` serves a trained checkpoint.  The fused train
steps of the backbones and the cohort steps are in
``repro_torch.core.spmd``.
"""
from repro_torch.api.engines import (AUTO_ORDER, Engine, SessionContext,  # noqa: F401
                                     available_engines, get_engine,
                                     register_engine, resolve_engine)
from repro_torch.api.evaluation import SplitEvaluator, pad_batches  # noqa: F401
from repro_torch.api.fused_engine import FusedEngine  # noqa: F401
from repro_torch.api.protocol import SplitModel, assert_split_model  # noqa: F401
from repro_torch.api.reference_engine import ReferenceEngine  # noqa: F401
from repro_torch.api.serve_session import (ServeResult, ServeSession,  # noqa: F401
                                           ServeStats, assemble_serve_params,
                                           resolve_serve_boundary,
                                           sequential_reference,
                                           sequential_sticky_reference,
                                           serve_step_config)
from repro_torch.api.session import TrainSession  # noqa: F401
from repro_torch.api.spmd_engine import SpmdEngine  # noqa: F401
from repro_torch.api.state import (ShardedTrainState, TrainState,  # noqa: F401
                                   init_train_state)
