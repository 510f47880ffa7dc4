"""Live web-demo backend for the browser apps under src/web/ (the counterpart
of saev_tpu/web).

`python -m saev_tpu_torch.web --help` serves the three demo apps against real run
artifacts; see backend.py for the endpoint contract (the API surface of the
reference's Gradio spaces that its Elm apps call).
"""

from .backend import (  # noqa: F401
    ClassificationApp,
    ComparisonApp,
    SemsegApp,
    make_server,
)
