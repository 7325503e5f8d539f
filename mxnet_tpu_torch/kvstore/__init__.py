"""Key-value store pieces of the port (counterpart of ``mxnet_tpu/kvstore``).
Ported so far: the block-scaled codec (:mod:`.quant`), whose wire format
the int4 weight tables of ``contrib.quantization`` store, and the KV page
wire of the serving fleet (:mod:`.comm`'s ``encode_kv_pages`` /
``decode_kv_pages``)."""
