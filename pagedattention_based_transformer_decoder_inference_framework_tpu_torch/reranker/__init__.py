from .api import (CrossEncoderScorer, LogProbScorer, Reranker,
                  RerankScorer)

__all__ = ["Reranker", "RerankScorer", "LogProbScorer",
           "CrossEncoderScorer"]
