from .batcher import BatcherStats, DynamicBatcher
from .server import GraspServer, make_batch_generate_from_parts

__all__ = ["BatcherStats", "DynamicBatcher", "GraspServer", "make_batch_generate_from_parts"]
