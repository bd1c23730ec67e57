from .forward_pass import (  # noqa: F401
    ForwardPass,
    RayNetForwardPass,
    get_forward_pass_factory,
)
