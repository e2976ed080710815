"""Serving of the port, after the JAX package's `repro.serve`.

`frontdoor` is the overload-tolerant facade over the index `QueryEngine`
(admission control, deadline-aware micro-batching, graceful degradation);
`engine` is the LM decode serving engine.
"""

from repro_torch.serve.admission import (CLASS_BULK,  # noqa: F401
                                         CLASS_INTERACTIVE, AdmissionQueue,
                                         RejectedError)
from repro_torch.serve.deadline import (Deadline,  # noqa: F401
                                        ServiceEstimator)
from repro_torch.serve.engine import (GenerationResult,  # noqa: F401
                                      ServeEngine, make_serve_step)
from repro_torch.serve.frontdoor import (FrontDoor,  # noqa: F401
                                         FrontDoorClosed, Request,
                                         ServeResult)
