"""The system under test: the port's `VisionServer` behind its
`AdmissionController`, built from a configuration file and the
benchmark's own weights.

The configuration's ``program`` entry names the port's config class
(module and class); ``sizes`` are its arguments.  The server runs the
float mode with the traffic's buckets and no fusion policy, so the
configuration's layers are fused and not grouped; the controller keeps
its default in-flight ring and measures its bucket latencies itself, as a
deployment's would, with the traffic's number of probes.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, Mapping, Tuple


def _hashable(v: Any) -> Any:
    return tuple(_hashable(x) for x in v) if isinstance(v, list) else v


def program_config(config: Mapping[str, Any]) -> Any:
    prog = config["program"]
    cls = getattr(importlib.import_module(prog["module"]), prog["config"])
    return cls(name=prog["name"],
               **{k: _hashable(v) for k, v in config["sizes"].items()})


def build_libraries(names) -> Dict[str, str]:
    """Compile the configuration's CUDA libraries in parallel into the
    checkout's build directory (a no-op when they are there)."""
    from repro_torch.kernels import build
    return build.build_all(list(names))


def loaded_libraries():
    from repro_torch.kernels import build
    return sorted(build._loaded)


def serve(config: Mapping[str, Any], traffic, params,
          device: str) -> Tuple[Any, Any]:
    """(server, controller) for ``params`` on ``device``."""
    from repro_torch.launch.admission import AdmissionController
    from repro_torch.launch.vision_serve import ServeConfig, VisionServer
    name = config["name"]
    sc = ServeConfig(mode="float", buckets=tuple(traffic.buckets),
                     device=device)
    server = VisionServer(program_config(config), params, serve_cfg=sc,
                          model_name=name)
    return server, AdmissionController(
        {name: server}, measure_repeats=traffic.latency_probes)


def ops_module():
    from repro_torch.kernels import ops
    return ops
