"""JSON-over-stdio service frontend: the buffer-ABI analog for embedders.

The reference exposes the six phase functions to JS/Java/ObjC through
buffer-passing ABIs (wasm.cpp:32-201, android.cpp:43-130, ios.mm:23-100).
On a TPU host the equivalent embedding surface is a line-delimited JSON
protocol: one request object per line on stdin, one response per line on
stdout; binary blobs travel base64-encoded.

Request:  {"id": 1, "method": "generate_vote", "params": {...}}
Response: {"id": 1, "result": {...}} or {"id": 1, "error": "..."}

Methods mirror the SDK: generate_voter_keypair, admin_keygen,
init_election, generate_vote(s), verify_vote, tally_votes, verify_tally,
decode_result.

Counterpart of ``vote_saver_tpu/frontends/service.py``, with the same
methods and wire format.  The device-bound methods run on ``--device``
(the card by default).  Stdout carries the response lines and nothing
else: whatever the kernel build, the native library's compiler or torch
would print goes to stderr.  Run: python -m vote_saver_tpu_torch.frontends.service
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import json
import sys

from .. import sdk
from ..utils.rng import FrRandom


def _enc(v):
    if isinstance(v, bytes):
        return {"b64": base64.b64encode(v).decode()}
    if dataclasses.is_dataclass(v):
        return {k: _enc(x) for k, x in dataclasses.asdict(v).items()}
    if isinstance(v, (list, tuple)):
        return [_enc(x) for x in v]
    return v


def _dec_blob(v) -> bytes:
    return base64.b64decode(v["b64"] if isinstance(v, dict) else v)


def handle(request: dict, device="cuda") -> dict:
    method = request.get("method")
    p = request.get("params", {})
    rng = FrRandom(p["seed"]) if "seed" in p else None
    kw_depth = {k: p[k] for k in ("tree_depth", "eid_bits") if k in p}

    def keys():
        return sdk.AdminKeys(**{k: _dec_blob(p["keys"][k]) for k in p["keys"]})

    def election():
        return sdk.Election(**{k: _dec_blob(p["election"][k]) for k in p["election"]})

    if method == "generate_voter_keypair":
        return _enc(sdk.generate_voter_keypair(rng))
    if method == "admin_keygen":
        return _enc(sdk.admin_keygen(rng=rng, device=device, **kw_depth))
    if method == "init_election":
        pks = [_dec_blob(b) for b in p["public_keys"]]
        return _enc(sdk.init_election(pks, rng=rng, device=device, **kw_depth))
    if method == "generate_vote":
        return _enc(
            sdk.generate_vote(keys(), election(), p["voter_idx"], p["vote"],
                              _dec_blob(p["secret_key"]), rng=rng, device=device, **kw_depth)
        )
    if method == "generate_votes":
        sks = [_dec_blob(b) for b in p["secret_keys"]]
        return _enc(
            sdk.generate_votes(keys(), election(), p["voter_indices"], p["votes"],
                               sks, rng=rng, device=device, **kw_depth)
        )
    if method == "verify_vote":
        ballot = sdk.Ballot(**{k: _dec_blob(p["ballot"][k]) for k in p["ballot"]})
        return {"ok": sdk.verify_vote(keys(), ballot)}
    if method == "tally_votes":
        cts = [_dec_blob(b) for b in p["cts"]]
        dec_proof, voting_res = sdk.tally_votes(keys(), cts, **{k: p[k] for k in ("tree_depth",) if k in p})
        return {"dec_proof": _enc(dec_proof), "voting_res": _enc(voting_res)}
    if method == "verify_tally":
        cts = [_dec_blob(b) for b in p["cts"]]
        ok = sdk.verify_tally(keys(), cts, _dec_blob(p["voting_res"]),
                              _dec_blob(p["dec_proof"]),
                              **{k: p[k] for k in ("tree_depth",) if k in p})
        return {"ok": ok}
    if method == "decode_result":
        return {"counts": sdk.decode_result(_dec_blob(p["voting_res"]))}
    raise ValueError(f"unknown method {method!r}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="vote_saver_tpu_torch.frontends.service")
    ap.add_argument("--device", default="cuda", help="cuda (default), cpu, or host (admin_keygen, init_election)")
    args = ap.parse_args(argv)
    out = sys.stdout
    sys.stdout = sys.stderr  # stdout carries the response lines only
    try:
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            req = json.loads(line)
            try:
                resp = {"id": req.get("id"), "result": handle(req, args.device)}
            except Exception as exc:  # noqa: BLE001 - service boundary
                resp = {"id": req.get("id"), "error": f"{type(exc).__name__}: {exc}"}
            print(json.dumps(resp), file=out, flush=True)
    finally:
        sys.stdout = out


if __name__ == "__main__":
    main()
