"""Hand-written Adam and the learning-rate schedules of the port
(counterpart of ``repro/optim``)."""
from repro_torch.optim.adam import (AdamState, adam_init,  # noqa: F401
                                    adam_update, global_norm)
from repro_torch.optim.schedule import (cosine_schedule,  # noqa: F401
                                        make_schedule)
