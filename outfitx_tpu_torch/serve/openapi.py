"""OpenAPI 3.0 description of the serving API (served at /api/openapi.json).

This package's copy of ``outfitx_tpu/serve/openapi.py``. The document is kept
word for word, title and description included, so a client generated against
either package's server sees one contract; a test holds ``build_spec()``
equal to the JAX package's and in step with ``app.make_handler``'s routes.
"""

from __future__ import annotations

_ITEM_IDS = {
    "type": "array",
    "items": {"type": "integer"},
    "description": "catalog item ids",
}
_EMBEDDINGS = {
    "type": "array",
    "items": {"type": "array", "items": {"type": "number"}},
    "description": "one d_embed-length float vector per item",
}
_SCORED_ITEMS = {
    "type": "array",
    "items": {
        "type": "object",
        "properties": {
            "item_id": {"type": "integer"},
            "description": {"type": "string"},
            "distance": {"type": "number"},
        },
    },
}
_ERROR = {
    "type": "object",
    "properties": {"error": {"type": "string"}},
    "required": ["error"],
}


def _json_op(summary, request=None, response=None, params=None, tags=None,
             errors=()):
    """One JSON operation. ``errors`` lists exactly the non-500 error
    responses this route can actually produce, as (code, description)
    pairs — the handler's status behavior is the source of truth
    (``app.make_handler``; its last-resort 500 applies to every route)."""
    responses = {
        "200": {
            "description": "success",
            "content": {"application/json": {
                "schema": response or {"type": "object"},
            }},
        },
    }
    for code, desc in errors:
        responses[code] = {
            "description": desc,
            "content": {"application/json": {"schema": _ERROR}},
        }
    responses["500"] = {
        "description": "internal error",
        "content": {"application/json": {"schema": _ERROR}},
    }
    op = {"summary": summary, "responses": responses}
    if request is not None:
        op["requestBody"] = {
            "required": True,
            "content": {"application/json": {"schema": request}},
        }
    if params:
        op["parameters"] = params
    if tags:
        op["tags"] = tags
    return op


# The status codes each route can actually emit (mirrors app.make_handler:
# missing/garbage fields -> 400, UnknownItemError -> 404, absent test
# split -> 404; /api/add_items rejects duplicates/capacity as 400 and
# never 404s — it only ever introduces ids).
_E400 = ("400", "malformed request (missing field / wrong types)")
_E404_ITEM = ("404", "unknown item_id")
_E404_SPLIT = ("404", "test split not loaded")


def _outfit_request(extra=None, required=("outfit",)):
    props = {"outfit": _ITEM_IDS}
    props.update(extra or {})
    return {"type": "object", "properties": props,
            "required": list(required)}


def build_spec() -> dict:
    """The full spec; paths must equal app.make_handler's JSON API routes."""
    n_param = [{
        "name": "n", "in": "query", "required": False,
        "schema": {"type": "integer", "minimum": 1, "maximum": 32},
        "description": "number of sampled rows (clamped to [1, 32])",
    }]
    paths = {
        "/api/health": {"get": _json_op(
            "liveness + mock-mode flag",
            response={"type": "object", "properties": {
                "ok": {"type": "boolean"}, "mock": {"type": "boolean"}}},
            tags=["ops"],
        )},
        "/api/stats": {"get": _json_op(
            "per-route request counts / latency percentiles / error totals "
            "+ engine catalog occupancy + host RSS/uptime (the replica-"
            "recycling signals consumed by --max-rss-gb/--max-age)",
            tags=["ops"],
        )},
        "/api/openapi.json": {"get": _json_op(
            "this document", tags=["ops"],
        )},
        "/api/cp": {"post": _json_op(
            "compatibility score for one outfit (sigmoid of the CP head)",
            request=_outfit_request(),
            response={"type": "object",
                      "properties": {"score": {"type": "number"}}},
            tags=["inference"], errors=(_E400, _E404_ITEM),
        )},
        "/api/cp_batch": {"post": _json_op(
            "compatibility scores for many outfits in one device program",
            request={"type": "object", "properties": {
                "outfits": {"type": "array", "items": _ITEM_IDS}},
                "required": ["outfits"]},
            response={"type": "object", "properties": {
                "scores": {"type": "array", "items": {"type": "number"}}}},
            tags=["inference"], errors=(_E400, _E404_ITEM),
        )},
        "/api/cir": {"post": _json_op(
            "top-10 complementary items for an outfit + target description",
            request=_outfit_request(
                {"target": {"type": "string",
                            "description": "target item text"}},
                required=("outfit", "target")),
            response={"type": "object",
                      "properties": {"items": _SCORED_ITEMS}},
            tags=["inference"], errors=(_E400, _E404_ITEM),
        )},
        "/api/fitb": {"post": _json_op(
            "pick the best of 4 candidates for the blank (argmin distance)",
            request=_outfit_request(
                {"candidates": _ITEM_IDS},
                required=("outfit", "candidates")),
            response={"type": "object", "properties": {
                "pick": {"type": "integer",
                         "description": "index into candidates"}}},
            tags=["inference"], errors=(_E400, _E404_ITEM),
        )},
        "/api/similar": {"get": _json_op(
            "nearest-neighbour items for a catalog item",
            params=[{
                "name": "item_id", "in": "query", "required": True,
                "schema": {"type": "integer"},
            }],
            response={"type": "object",
                      "properties": {"items": _SCORED_ITEMS}},
            tags=["inference"],
            errors=(("400", "item_id query param required"), _E404_ITEM),
        )},
        "/api/sample": {"get": _json_op(
            "random catalog outfit (ids + descriptions)", params=n_param,
            tags=["browse"],
        )},
        "/api/sample_cp": {"get": _json_op(
            "sampled CP test rows: ground truth label vs predicted score",
            params=n_param, tags=["browse"], errors=(_E404_SPLIT,),
        )},
        "/api/sample_cir": {"get": _json_op(
            "sampled CIR test rows: ground-truth target vs retrieved top-k",
            params=n_param, tags=["browse"], errors=(_E404_SPLIT,),
        )},
        "/api/sample_fitb": {"get": _json_op(
            "sampled FITB test rows: answer vs model pick over 4 candidates",
            params=n_param, tags=["browse"], errors=(_E404_SPLIT,),
        )},
        "/api/update_items": {"post": _json_op(
            "live in-place embedding refresh for existing catalog rows "
            "(requests may race reads; donated row-scatter on device)",
            request={"type": "object", "properties": {
                "item_ids": _ITEM_IDS, "embeddings": _EMBEDDINGS,
                "descriptions": {"type": "array",
                                 "items": {"type": "string"}}},
                "required": ["item_ids", "embeddings"]},
            response={"type": "object",
                      "properties": {"updated": {"type": "integer"}}},
            tags=["catalog"], errors=(_E400, _E404_ITEM),
        )},
        "/api/add_items": {"post": _json_op(
            "append new items into reserved spare capacity "
            "(no shape change / re-trace; see cli demo --spare-capacity)",
            request={"type": "object", "properties": {
                "item_ids": _ITEM_IDS, "embeddings": _EMBEDDINGS,
                "category_ids": {"type": "array",
                                 "items": {"type": "integer"}},
                "semantic_categories": {"type": "array",
                                        "items": {"type": "string"}},
                "descriptions": {"type": "array",
                                 "items": {"type": "string"}}},
                "required": ["item_ids", "embeddings"]},
            response={"type": "object", "properties": {
                "added": {"type": "integer"},
                "n_items": {"type": "integer"},
                "capacity": {"type": "integer"}}},
            tags=["catalog"], errors=(_E400,),
        )},
        "/images/{item_id}.jpg": {"get": {
            "summary": "item image (when the dataset ships images/)",
            "parameters": [{
                "name": "item_id", "in": "path", "required": True,
                "schema": {"type": "integer"},
            }],
            "responses": {
                "200": {"description": "JPEG bytes",
                        "content": {"image/jpeg": {}}},
                "400": {"description": "non-integer image name",
                        "content": {"application/json": {
                            "schema": _ERROR}}},
                "404": {"description": "no image for this id",
                        "content": {"application/json": {
                            "schema": _ERROR}}},
                # The _timed last-resort wrap (app.py) applies to this route
                # too: an image deleted between is_file and read_bytes yields
                # a JSON-wrapped 500, same as every other route.
                "500": {"description": "unexpected server error",
                        "content": {"application/json": {
                            "schema": _ERROR}}},
            },
            "tags": ["browse"],
        }},
    }
    return {
        "openapi": "3.0.3",
        "info": {
            "title": "outfitx_tpu serving API",
            "version": "1.0.0",
            "description": (
                "TPU-native outfit compatibility / retrieval serving "
                "(stdlib HTTP; each task is one pre-warmed jitted device "
                "program). The HTML UI at / consumes these endpoints."
            ),
        },
        "paths": paths,
    }
