from repro_torch.models.model import Model, make_model  # noqa: F401
