"""Web layer: in-tree WSGI micro-framework + the two product frontends.

`create_api_app` — headless JSON service (FastAPI-app parity).
`create_web_app` — browser UI with status feed + history (Flask-app parity).
Both are thin shells over `app.pipeline.Pipeline`; wiring (models, SQL
backend, history store) is injected so tests run hermetically with fake
backends (SURVEY.md §4).

Copies of the JAX package's `app/` modules over the port's serving stack;
`__main__` is the port's own entry point (`python -m
llm_based_apache_spark_optimization_tpu_torch.app --help`). `/metrics` and
`/debug/*` are not served yet (ROADMAP A12).
"""

from .api import create_api_app  # noqa: F401
from .config import AppConfig  # noqa: F401
from .pipeline import Pipeline, PipelineResult  # noqa: F401
from .web import create_web_app, secure_filename  # noqa: F401
from .wsgi import App, Request, Response  # noqa: F401
