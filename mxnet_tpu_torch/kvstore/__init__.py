"""Key-value store pieces of the port (counterpart of ``mxnet_tpu/kvstore``).
Only the block-scaled codec (:mod:`.quant`) is ported so far: the int4
weight tables of ``contrib.quantization`` store its wire format."""
