"""One run of one cell: set-up, the measured window, the check of what the
window produced, and the result line.

Set-up: the seeded checkpoints (written once a checkout), the program's
kernels (built once a checkout), the traffic's pool of scenes (textures
from its texture_seed, the same every run) in an order drawn from --seed,
and one warm-up reconstruct of a smaller scene at the cell's resolution.
The window: one client reconstructing scenes of the pool back to back through
mpsfm_tpu_torch.pipeline.reconstruct, each in fresh cache and output
directories, until --seconds have passed; the scene in flight finishes.
Then the check (the configuration's `checks`, reference/*.py) on a scene
drawn from the seed, and the result.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import json
import math
import shutil
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

from sfmb import peaks, scenes
from sfmb.spec import Spec
from sfmb.spies import Spy, keeper, targets
from sfmb.trace import DeviceRecord, HostSpans, device_events

FORBIDDEN = {"jax", "jaxlib", "flax", "mpsfm_tpu"}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules():
    """Top-level names of loaded modules that the run may not hold, compared
    whole (mpsfm_tpu_torch is not mpsfm_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def written_bytes():
    """{wchar, write_bytes} of this process (Linux's /proc/self/io: bytes
    handed to write calls, and bytes sent to the storage layer), or {}
    where the system does not say."""
    try:
        lines = Path("/proc/self/io").read_text().splitlines()
    except OSError:
        return {}
    return {k: int(v) for k, v in (line.split(": ") for line in lines) if k in ("wchar", "write_bytes")}


def write_weights(spec, cfg, device):
    """Each net's seeded checkpoint under sfmbench/.weights/<config>/, made
    where missing (float16 values). Returns ({net: path}, seconds spent
    making them)."""
    import torch

    t = time.perf_counter()
    d = spec.folder / ".weights" / cfg["name"]
    paths = {}
    for net, ns in cfg["nets"].items():
        path = d / ns["file"]
        paths[net] = path
        if path.exists():
            continue
        d.mkdir(parents=True, exist_ok=True)
        maker = spec.module("weights", net)
        ref = spec.module("reference", net) if (spec.folder / "reference" / f"{net}.py").exists() else None
        sd = maker.state_dict(ns, device, ref)
        sd = {k: v.to(torch.float16).cpu() for k, v in sd.items()}
        tmp = path.with_suffix(".tmp")
        torch.save(sd, tmp)
        tmp.replace(path)
        del sd
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return paths, time.perf_counter() - t


def program_conf(cfg, paths):
    conf = copy.deepcopy(cfg["conf"])
    for net, ns in cfg["nets"].items():
        *keys, last = ns["conf_key"].split(".")
        d = conf
        for k in keys:
            d = d.setdefault(k, {})
        d[last] = str(paths[net])
    return conf


class Run:
    """What the readers (metrics/*.py) read."""

    def __init__(self, spec, cfg, scenes_done, calls, device_record, window_s):
        self.spec, self.cfg, self.scenes, self.calls = spec, cfg, scenes_done, calls
        self.device, self.window_s = device_record, window_s

    def roofline(self, name):
        mod = self.spec.module("counts", name)
        recs = self.calls.get(name) or []
        if not recs or self.device is None:
            return None
        least = sum(mod.least_s(r, peaks) for r in recs)
        dev = self.device.kernel_s([p for pats in mod.KERNELS.values() for p in pats])
        return 100.0 * least / dev if dev > 0 else None

    def counted_least_s(self):
        return sum(self.spec.module("counts", n).least_s(r, peaks) for n in self.cfg["counted"]
                   for r in self.calls.get(n, []))


class CheckContext:
    """What the references (reference/*.py) are given: the sampled scene's
    images and intrinsics, the program's outputs read from its caches, the
    kernels' last calls, the window's scene records (each scene's truth and
    the program's poses), the nets' files, a generator drawn from the
    seed."""

    def __init__(self, cfg, paths, scene, cache, conf, kept, device, rng, control=False, window=()):
        self.cfg, self.paths, self.scene, self.cache = cfg, paths, scene, Path(cache)
        self.window = list(window)
        self.fmt = conf.get("cache_format", "h5")
        self.conf, self.kept, self.device, self.rng = conf, kept, device, rng
        self.control = control

    def net(self, name):
        return {**self.cfg["nets"][name], "path": str(self.paths[name])}

    def scene_images(self):
        return list(zip(self.scene["names"], self.scene["images"]))

    def intrinsics(self, name):
        return self.scene["intrinsics"]

    def image_wh(self, name):
        img = self.scene["images"][self.scene["names"].index(name)]
        return img.shape[1], img.shape[0]

    def _store(self, stem):
        from mpsfm_tpu_torch.utils import io

        return io.store_path(self.cache, stem, self.fmt)

    def scene_pairs(self):
        from mpsfm_tpu_torch.utils import io

        return io.read_pairs(self.cache / "pairs.txt")

    def program_features(self, name):
        from mpsfm_tpu_torch.utils import io

        path = self._store("feats-" + self.conf["extractors"]["features"])
        return io.get_keypoints(path, name), io.get_descriptors(path, name)

    def expected_pairs(self):
        """The pairs the configuration asks for: every pair of the scene
        where its pairs are exhaustive or retrieval keeps them all
        (n_retrieval at least the images less one), each in the program's
        order where the program has it; else the program's pairs."""
        import itertools

        ex, names = self.conf["extractors"], self.scene["names"]
        have = [tuple(p) for p in self.scene_pairs()]
        if ex.get("pairs_type") == "exhaustive" or ex.get("n_retrieval", 0) >= len(names) - 1:
            return [(b, a) if (b, a) in have and (a, b) not in have else (a, b)
                    for a, b in itertools.combinations(names, 2)]
        return have

    def program_matches(self, a, b):
        """matches0 of pair (a, b) from the match cache; all -1 where the
        cache lacks the pair."""
        from mpsfm_tpu_torch.utils import io

        out = np.full(len(io.get_keypoints(self._store("feats-" + self.conf["extractors"]["features"]), a)), -1)
        try:
            m, _ = io.get_matches(self._store("matches-" + self.conf["extractors"]["matcher"]), a, b)
        except (KeyError, ValueError):
            return out
        out[m[:, 0]] = m[:, 1]
        return out

    def program_mono(self, name):
        from mpsfm_tpu_torch.utils import io

        return io.get_mono_map(self._store("depth-" + self.conf["extractors"].get("depth", "oracle")), name)

    def program_pair_depth(self, a, b):
        """Each view's two-view depth of pair (a, b) from the pair-depth cache."""
        from mpsfm_tpu_torch.utils import io

        with io.open_store(self._store("pair-depth-" + self.conf["extractors"]["dense_matcher"]), "r") as f:
            return [np.asarray(f[f"{io.names_to_pair(a, b)}/{n}"]["depth"][:], np.float64) for n in (a, b)]


    def note(self, line):
        """A line of the check's own on standard error."""
        log(("control " if self.control else "") + line)

    def last_calls(self, kind):
        """[(args, result)] of the last calls the scene made under `kind` of
        the configuration's `calls` (as many as it keeps), newest first."""
        return list(reversed(self.kept.get(kind) or []))

    def last_call(self, kind):
        """(args, result) of the scene's last call under `kind`, or None."""
        calls = self.last_calls(kind)
        return calls[0] if calls else None

    def window_calls(self, kind):
        """The kept calls under `kind` of the sampled scene, newest first,
        then those of the window's other scenes, the last scene first."""
        calls = self.last_calls(kind)
        for rec in reversed(self.window):
            if rec.get("calls") is not self.kept:
                calls += list(reversed(rec.get("calls", {}).get(kind) or []))
        return calls

    def kernel_calls(self, kind):
        call = self.last_call(kind)
        if call is None:
            return []
        args, out = call
        return [(args[:5], out)]

    @contextlib.contextmanager
    def lower_precision(self):
        """TF32 on for float32 products and convolutions: the precision below
        the configuration's float32 with TF32 off."""
        import torch

        saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def reconstruct_scene(reconstruct, timers, scene, conf, work, device):
    """One scene through reconstruct in fresh cache and output directories
    under `work`. Returns its record (the cache directory kept for the
    check; the outputs deleted)."""
    import torch

    cache = Path(tempfile.mkdtemp(prefix="cache-", dir=work))
    out = Path(tempfile.mkdtemp(prefix="out-", dir=work))
    timers.reset()
    rec_s = {"images": len(scene["names"]), "registered": 0, "cache": cache, "scene": scene}
    t = time.perf_counter()
    try:
        rec, _ = reconstruct(scene["dir"], conf=conf, cache_dir=cache, sfm_outputs_dir=out, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    except Exception:  # noqa: BLE001 - a scene that raises counts its images as failed
        log(f"scene {scene['dir']} raised:\n{traceback.format_exc()}")
        rec = None
    rec_s["wall_s"] = time.perf_counter() - t
    rec_s["extract_s"] = sum(v for k, v in timers.totals.items() if k.startswith("pipe.extract_"))
    if rec is not None:
        rec_s.update(registered=rec.num_reg_images(), finished=True,
                     poses={im.name: (im.pose.rotation_matrix(), np.asarray(im.pose.t, np.float64))
                            for im in rec.images.values() if im.registered})
    shutil.rmtree(out, ignore_errors=True)
    return rec_s


def run(args, device_name="cuda", root=None, faults=(), control=False):
    """The run of args.workload; returns (exit code, result dict or None).
    `faults` name files of faults/ planted under the timed path, and
    `control` puts the reference one precision lower in the program's
    place in the check (tests and the limits' readings only)."""
    t0 = args.t0
    import torch

    device = torch.device(device_name)
    spec = Spec(root or Path.cwd())
    cell = spec.cell(args.workload)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    paths, weights_s = write_weights(spec, cfg, device)

    from mpsfm_tpu_torch import kernels
    from mpsfm_tpu_torch.pipeline import reconstruct
    from mpsfm_tpu_torch.utils.profiling import TIMERS

    build_s = kernels.build_all(kernels.all_kernels()) if device.type == "cuda" else 0.0
    conf = program_conf(cfg, paths)
    work = Path(tempfile.mkdtemp(prefix="sfmbench-"))
    try:
        t = time.perf_counter()
        tex = traffic["texture_seed"]
        order = np.random.default_rng([args.seed % 2**63, 11]).permutation(traffic["pool"])
        pool = [scenes.make_scene(work / f"scene{i}", tex, int(i), traffic, traffic["images"], device) for i in order]
        warm = scenes.make_scene(work / "warmup", tex, -1, traffic, traffic["warmup_images"], device)
        render_s = time.perf_counter() - t
        planted = [spec.module("faults", f).plant() for f in faults]
        with contextlib.ExitStack() as stack:
            for p in planted:
                stack.enter_context(p)
            t = time.perf_counter()
            reconstruct_scene(reconstruct, TIMERS, warm, conf, work, device)
            warm_s = time.perf_counter() - t
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            setup_s = time.perf_counter() - t0
            keepers = {k: keeper(entry) for k, entry in cfg.get("calls", {}).items()}
            counted = {n: [] for n in cfg["counted"]} if args.trace else {}
            for k, entry in cfg.get("calls", {}).items():
                for mod, attr in targets(entry):
                    stack.enter_context(Spy(mod, attr, keepers[k]))
            for n in counted:
                cm = spec.module("counts", n)
                stack.enter_context(Spy(*cm.TARGET, lambda a, kw, o, cm=cm, n=n: counted[n].append(cm.record(a, kw, o))))
            spans = HostSpans()
            prof = None
            if args.trace:
                from torch.profiler import ProfilerActivity, profile

                stack.enter_context(spans.around_phases(TIMERS))
                prof = profile(activities=[ProfilerActivity.CUDA])
                prof.__enter__()
            window, i = [], 0
            w0_ns, w0 = time.time_ns(), time.perf_counter()
            try:
                while True:
                    scene = pool[i % len(pool)]
                    with spans.span("scene"):
                        s = reconstruct_scene(reconstruct, TIMERS, scene, conf, work, device)
                    s["calls"] = {k: keep.take() for k, keep in keepers.items()}
                    window.append(s)
                    i += 1
                    if time.perf_counter() - w0 >= args.seconds:
                        break
            finally:
                w1_ns, w1 = time.time_ns(), time.perf_counter()
                if prof is not None:
                    prof.__exit__(None, None, None)
        window_s = w1 - w0
        mem_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        record = None
        if prof is not None:
            record = DeviceRecord(device_events(prof), spans.spans, w0_ns, w1_ns)
            log(f"trace: {len(record.by_name)} kernel names, busy {record.busy_s:.3f} s of "
                f"{record.window_s:.3f} s, {record.outside} events outside the window")
            del prof
        attempted = sum(s["images"] for s in window)
        registered = sum(s["registered"] for s in window)
        metrics = {}
        the_run = Run(spec, cfg, window, counted, record, window_s)
        if args.trace:
            for m in spec.metrics(cell, "per_layer"):
                v = spec.module("metrics", m["name"]).read(the_run)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            e2e = {"frames_per_s": registered / window_s, "setup_s": setup_s}
            for m in spec.metrics(cell, "end_to_end"):
                if m["name"] in e2e:
                    metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
        log(f"setup: weights {weights_s:.3f} s (made only by a checkout's first run), kernels {build_s:.3f} s, "
            f"scenes {render_s:.3f} s, warm-up reconstruct {warm_s:.3f} s; setup_s {setup_s:.3f}")
        log(f"window: {len(window)} scenes, {registered}/{attempted} images registered in {window_s:.3f} s; "
            f"scene walls {[round(s['wall_s'], 3) for s in window]}; extract {[round(s['extract_s'], 3) for s in window]}; "
            f"registered {[s['registered'] for s in window]}")
        del counted, the_run
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        numbers = check(spec, cfg, paths, conf, window, device, args.seed, control=control)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    found = forbidden_modules()
    if found:
        log(f"the run loaded {found}: no result")
        return 3, None
    log(f"bytes written by this process: {written_bytes()}")
    limits = cfg["limits"]
    # a number that is missing or not finite fails, and prints as null
    numbers = {k: v for k, v in numbers.items() if math.isfinite(v)}
    correct = all(k in numbers and numbers[k] <= limits[k] for k in limits)
    for k in limits:
        log(f"check {k}: {numbers.get(k)} (limit {limits[k]})")
    result = {"correct": correct, "attempted": attempted, "failed": attempted - registered, "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                         "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                         "count": 1, "memory_peak_bytes": int(mem_peak)}}
    if record is not None:
        result["device"].update(busy_s=record.busy_s, window_s=record.window_s)
        result["breakdown"] = record.breakdown()
    result["checked"] = {k: {"value": numbers.get(k), "limit": limits[k]} for k in limits}
    return 0, result


def check(spec, cfg, paths, conf, window, device, seed, control=False):
    """The configuration's checks on one finished scene of the window drawn
    from the seed. Returns {number: value}."""
    done = [s for s in window if s.get("finished")]
    if not done:
        log("check: no scene of the window finished")
        return {}
    rng = np.random.default_rng([seed % 2**63, 7])
    pick = done[int(rng.integers(len(done)))]
    ctx = CheckContext(cfg, paths, pick["scene"], pick["cache"], conf, pick["calls"], device, rng, control=control,
                       window=window)
    numbers = {}
    for name in cfg["checks"]:
        numbers.update(spec.module("reference", name).compare(ctx))
    return numbers


def main(argv, t0):
    import argparse

    ap = argparse.ArgumentParser(description="sfmbench: one run of one cell (see BENCHMARK.json)")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    args.t0 = t0
    import torch

    root = Path.cwd()
    cell = Spec(root).cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"sfmbench: {cell['chips']} CUDA device(s) wanted, "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    code, result = run(args, "cuda", root)
    if result is not None:
        print(json.dumps(result), flush=True)
    return code
