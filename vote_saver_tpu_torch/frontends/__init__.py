"""Platform frontends (L2 analogs), the counterparts of
``vote_saver_tpu/frontends/``.

The reference ships four frontends over one blob API: native CLI, WASM
(extern "C" buffer ABI), Android JNI and iOS NSData (SURVEY.md §1 L2).  On
a GPU host, as on a TPU host, the equivalents are:

  * vote_saver_tpu_torch.cli  — the native CLI (argv surface);
  * frontends.service         — newline-delimited JSON-RPC over stdio, the
    embedding surface for non-Python callers (native/vs_client.c and the
    mobile shims start it as their child);
  * frontends.c_api           — the six-function C ABI over ctypes;
  * vote_saver_tpu_torch.sdk  — the in-process Python SDK (wrapper.js analog).

Each runs on the card unless told another device.
"""
