from repro_torch.serving.batching import (Batcher, EndpointBatcher,  # noqa: F401
                                          pad_batch)
from repro_torch.serving.datastore import TieredDatastore  # noqa: F401
from repro_torch.serving.engine import (ModelEndpoint, ServingEngine,  # noqa: F401
                                        WarmBudget)
from repro_torch.serving.executor import Executor  # noqa: F401
from repro_torch.serving.weights import WeightStore  # noqa: F401
from repro_torch.specs import TensorSpec  # noqa: F401
