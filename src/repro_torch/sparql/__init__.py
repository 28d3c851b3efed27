"""SPARQL over the rewritten store (paper §5): the algebra, the host
executor and the batched matcher of the serving tier.  Copies of
``repro.sparql``'s host modules; the batched matcher is the port's."""

from .algebra import Query
from .batched import BatchedExecutor
from .executor import evaluate, evaluate_at, evaluate_naive

__all__ = ["BatchedExecutor", "Query", "evaluate", "evaluate_at", "evaluate_naive"]
