"""Online serving of the port: shape-bucketed micro-batching and the HTTP
front end, port of `vfi_tpu/serve/` (see batcher.py and server.py)."""

from vfi_tpu_torch.serve.batcher import BatcherStats, MicroBatcher
from vfi_tpu_torch.serve.server import (RAW_CONTENT_TYPE, SEQ_CONTENT_TYPE,
                                        InterpolationServer,
                                        encode_pair_body, encode_raw_body,
                                        encode_seq_body, split_pair_body,
                                        split_raw_body, split_seq_body)

__all__ = ["BatcherStats", "MicroBatcher", "InterpolationServer",
           "RAW_CONTENT_TYPE", "SEQ_CONTENT_TYPE", "encode_pair_body",
           "encode_raw_body", "encode_seq_body", "split_pair_body",
           "split_raw_body", "split_seq_body"]
