"""Pixie: the top-level VCGRA overlay accelerator facade.

Twin of the reference package's ``core/pixie.py``: its batched dispatches
take the reference's app-axis mesh (``mesh=MeshSpec(app=k)``).  It mirrors
the paper's operational model end to end:

  overlay compile (once)      <->  bind the conventional plan and run it
                                   once (builds the Hopper kernels)
  map application (<1 s)      <->  synthesis + place + route + settings gen
  reconfigure (ms)            <->  conventional: swap settings tensors
                                   parameterized: generate + NVRTC-compile
                                   + load the app's specialized kernel
  execute                     <->  run the pipelined PE grid on pixel batch

All stages are wall-clock timed (each time ends in a device synchronize);
the timings feed the compilation-gap comparison (paper Sec. V-E: <1 s
mapping vs ~1200 s FPGA compile).
"""

from __future__ import annotations

import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import applications as apps
from repro_torch.core import grid as gridlib
from repro_torch.core import interpreter, specialize
from repro_torch.core.bitstream import VCGRAConfig, assemble
from repro_torch.core.dfg import DFG
from repro_torch.core.grid import GridSpec
from repro_torch.core.ingest import IngestPlan
from repro_torch.core.place import place
from repro_torch.core.plan import OverlayExecutable, OverlayPlan, PipelineSpec, compile_plan
from repro_torch.core.route import route
from repro_torch.core.tiling import pad_channels
from repro_torch.parallel.axes import MeshSpec


def map_app(dfg: DFG, grid: GridSpec) -> VCGRAConfig:
    """The full VCGRA tool flow: netlist -> placement -> routing -> settings."""
    placement = place(dfg, grid)
    routing = route(placement, grid)
    return assemble(placement, routing, grid)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Pixie:
    """A virtual CGRA instance on one device (``device="cuda"`` by default;
    pass ``device="cpu"`` for the CPU, where the kernel wrappers compute
    their plain versions).

    mode='conventional'  settings are runtime tensors; reconfiguration is a
                         buffer swap and never rebuilds anything
                         (compile-once overlay).  ``backend`` picks the
                         plan cells: "hopper" (default) runs the
                         hand-written kernels -- B2 for ``run_raw`` and
                         ``run_many``, B1 for ``run_image``, B3 for
                         ``run_pipeline``, as the reference's Pallas cells
                         do -- and "torch" the eager interpreter.
    mode='parameterized' settings are baked constants; reconfiguration
                         re-specializes but executes a leaner datapath
                         (paper's TLUT/TCON flow).  The reference bakes one
                         app into an XLA executable and takes no other
                         backend; a card has no XLA to specialize for it,
                         so here "hopper" (default) generates the app's
                         own kernel (B5) and NVRTC-compiles it at
                         :meth:`load`, and "torch" runs the eager
                         ``specialize.build_specialized_fn``.
                         ``bake_consts`` also burns the coefficients in.

    ``mesh`` (a :class:`~repro_torch.parallel.axes.MeshSpec`) shards the app
    axis of the conventional mode's batched dispatches (``run_many``,
    ``run_pipeline``) over the local devices of ``device``'s type, bitwise
    the single-device run.  Only the app axis: row sharding needs the
    fleet's frame-canvas dispatch, so ``rows > 1`` is refused, and the
    parameterized mode, one app's kernel, takes no mesh.  The bare
    device-count kwarg survives as a DeprecationWarning shim for
    ``mesh=MeshSpec(app=k)``.
    """

    def __init__(self, grid: GridSpec, mode: str = "conventional", bake_consts: bool = False,
                 backend: str = "hopper", device="cuda", mesh: Optional[MeshSpec] = None,
                 devices: Optional[int] = None):
        if mode not in ("conventional", "parameterized"):
            raise ValueError(f"unknown mode {mode!r}")
        if devices is not None:
            d = int(devices)
            if d < 1:
                raise ValueError(f"devices must be >= 1, got {devices}")
            if mesh is not None:
                raise ValueError(
                    "pass mesh=MeshSpec(...) or the deprecated bare device "
                    "count, not both"
                )
            warnings.warn(
                "the bare device-count kwarg of Pixie is deprecated: pass "
                f"mesh=MeshSpec(app={d}) instead",
                DeprecationWarning, stacklevel=2,
            )
            mesh = MeshSpec(app=d)
        mesh = mesh or MeshSpec()
        if not isinstance(mesh, MeshSpec):
            raise ValueError(f"mesh must be a MeshSpec, got {mesh!r}")
        if mesh.rows > 1:
            raise ValueError(
                "Pixie shards the app axis only; row sharding needs the "
                "fleet's frame-canvas dispatch -- use PixieFleet with "
                f"mesh=MeshSpec(app={mesh.app}, rows={mesh.rows})"
            )
        if mode == "parameterized" and mesh != MeshSpec():
            raise ValueError(
                "mesh applies to the conventional overlay plans only; the "
                "parameterized path specializes per app"
            )
        self.mesh = mesh
        self.grid = grid
        self.mode = mode
        self.bake_consts = bake_consts
        self.backend = interpreter.check_backend(backend)
        self.device = interpreter.check_device(device)
        self.config: Optional[VCGRAConfig] = None
        self._overlay_fn: Optional[OverlayExecutable] = None
        self._batched_overlay_fn: Optional[OverlayExecutable] = None
        self._fused_fns: Dict[int, OverlayExecutable] = {}  # radius -> executable
        self._pipeline_fns: Dict[PipelineSpec, OverlayExecutable] = {}
        self._config_t = None
        self._ingest_t = None
        self._spec_fn: Optional[Callable] = None
        self.timings: Dict[str, float] = {}

    @property
    def devices(self) -> int:
        """App-axis mesh width (the reading side of the deprecated bare
        device-count surface)."""
        return self.mesh.app

    def _plan(self, *, batched: bool = False, fused: bool = False,
              radius: Optional[int] = None) -> OverlayPlan:
        """This instance's corner of the plan matrix (the mesh only shards
        batched dispatch: single-app plans have no app axis)."""
        return OverlayPlan(grid=self.grid, batched=batched, fused=fused, radius=radius,
                           backend=self.backend, mesh=self.mesh if batched else MeshSpec())

    def _compile(self, plan: OverlayPlan) -> OverlayExecutable:
        return compile_plan(plan, self.device.type)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    # -- stage 1: overlay compile (the "1200 s" FPGA-compile analogue) ------

    def compile_overlay(self, batch: int = 1024) -> float:
        """Bind the conventional overlay for this grid structure and, in
        conventional mode, run it once on a dummy config (which builds the
        Hopper kernels on first use).  Only meaningful in conventional
        mode."""
        t0 = time.perf_counter()
        self._overlay_fn = self._compile(self._plan())
        if self.mode == "conventional":
            x = torch.zeros((self.grid.num_inputs, batch), dtype=self.grid.dtype,
                            device=self.device)
            self._overlay_fn(self._dummy_config().to_torch(device=self.device), x)
            _sync(self.device)
        dt = time.perf_counter() - t0
        self.timings["overlay_compile_s"] = dt
        return dt

    def _dummy_config(self) -> VCGRAConfig:
        g = self.grid
        return VCGRAConfig(
            app_name="<dummy>",
            grid_name=g.name,
            opcodes=[np.zeros((p,), np.int32) for p in g.pes_per_level],
            selects=[np.zeros((p, 2), np.int32) for p in g.pes_per_level],
            out_sel=np.zeros((g.num_outputs,), np.int32),
            input_order=tuple(f"i{k}" for k in range(g.num_inputs)),
            const_values={},
        )

    # -- stage 2: map an application (the "<1 s" analogue) -------------------

    def map(self, dfg: DFG) -> VCGRAConfig:
        t0 = time.perf_counter()
        config = map_app(dfg, self.grid)
        self.timings["map_s"] = time.perf_counter() - t0
        return config

    # -- stage 3: (micro-)reconfiguration ------------------------------------

    def load(self, config: VCGRAConfig) -> float:
        """Install ``config``; returns the reconfiguration wall time (a
        settings copy to the device, or the specialized kernel's generate +
        compile + load)."""
        t0 = time.perf_counter()
        self.config = config
        self._ingest_t = (config.ingest.to_torch(self.grid.dtype, device=self.device)
                          if config.ingest else None)
        if self.mode == "conventional":
            self._config_t = config.to_torch(device=self.device)  # settings-register write
        elif self.backend == "hopper":
            self._spec_fn = specialize.jit_specialized(
                self.grid, config, bake_consts=self.bake_consts, device=self.device)
        else:
            self._spec_fn = specialize.build_specialized_fn(
                self.grid, config, bake_consts=self.bake_consts)
        _sync(self.device)
        dt = time.perf_counter() - t0
        self.timings["reconfig_s"] = dt
        return dt

    def run_dfg(self, dfg: DFG, **inputs) -> torch.Tensor:
        """map + load + run in one call (convenience)."""
        self.load(self.map(dfg))
        return self(**inputs)

    # -- stage 4: execution ----------------------------------------------------

    def run_raw(self, x) -> torch.Tensor:
        """x: [num_inputs, batch] -> y: [num_outputs, batch]."""
        if self.config is None:
            raise RuntimeError("no application loaded; call load() first")
        x = self._tensor(x).to(self.grid.dtype)
        if self.mode == "conventional":
            if self._overlay_fn is None:
                self.compile_overlay(batch=x.shape[-1])
            return self._overlay_fn(self._config_t, pad_channels(x, self.grid.num_inputs))
        return self._spec_fn(x)

    def __call__(self, **inputs) -> torch.Tensor:
        if self.config is None:
            raise RuntimeError("no application loaded; call load() first")
        x = interpreter.pack_inputs(self.config, inputs, self.grid.dtype, device=self.device)
        return self.run_raw(x)

    # -- stage 4b: multi-tenant execution --------------------------------------

    def run_many(
        self,
        requests: Sequence[Tuple[Union[DFG, VCGRAConfig], Dict[str, object]]],
        batch_pad: Optional[int] = None,
    ) -> List[torch.Tensor]:
        """Execute N applications on this overlay in ONE batched dispatch.

        ``requests``: (application, named-inputs) pairs; each application is
        a :class:`DFG` (mapped here) or a pre-mapped :class:`VCGRAConfig` for
        the same grid.  Conventional mode only.  ``batch_pad`` pads every
        app's pixel batch to this length (>= the largest request); ragged
        requests are zero-padded and the outputs sliced back, so results
        equal N sequential runs.  Returns one ``[num_outputs, batch_i]``
        tensor per request, in order.
        """
        if self.mode != "conventional":
            raise RuntimeError(
                "run_many requires mode='conventional' (the parameterized "
                "path specializes a single application per executable)"
            )
        if not requests:
            return []
        configs: List[VCGRAConfig] = []
        xs: List[torch.Tensor] = []
        for app, inputs in requests:
            cfg = app if isinstance(app, VCGRAConfig) else self.map(app)
            x = interpreter.pack_inputs(cfg, inputs, self.grid.dtype, device=self.device)
            if x.ndim != 2:
                raise ValueError(
                    f"run_many needs flat [channels, batch] inputs, got {tuple(x.shape)}"
                )
            configs.append(cfg)
            xs.append(pad_channels(x, self.grid.num_inputs))
        stacked, xstack, batches = interpreter.stack_for_dispatch(configs, xs, batch_pad)
        if self._batched_overlay_fn is None:
            self._batched_overlay_fn = self._compile(self._plan(batched=True))
        t0 = time.perf_counter()
        ys = self._batched_overlay_fn(stacked, xstack)
        _sync(self.device)
        self.timings["run_many_s"] = time.perf_counter() - t0
        return [ys[i, :, : batches[i]] for i in range(len(requests))]

    def run_image(self, image) -> torch.Tensor:
        """Run a loaded stencil application over a full [H, W] image.

        Conventional mode takes the fused-ingest path (tap bank, channel
        select and dispatch in one fused plan on this instance's backend),
        shared by every app mapped on the grid.  The parameterized mode (and
        apps without an ingest plan) takes the two-step path: the taps
        (``stencil_inputs``) and ``pack_inputs`` on the device, then
        :meth:`run_raw`.
        """
        if self.config is None:
            raise RuntimeError("no application loaded; call load() first")
        image = self._tensor(image)
        H, W = image.shape
        if self.mode == "conventional" and self.config.ingest is not None:
            radius = self.config.ingest.radius
            if radius not in self._fused_fns:
                self._fused_fns[radius] = self._compile(self._plan(fused=True, radius=radius))
            y = self._fused_fns[radius](self._config_t, self._ingest_t, image)
        else:
            taps = apps.stencil_inputs(image)
            feed = {k: v for k, v in taps.items() if k in self.config.input_order}
            y = self(**feed)
        return y.reshape((-1, H, W))[0] if y.shape[0] == 1 else y.reshape((-1, H, W))

    def run_pipeline(
        self,
        chain: Sequence[Union[DFG, VCGRAConfig, str]],
        image,
        out_channels: Optional[Sequence[int]] = None,
    ) -> torch.Tensor:
        """Run a multi-stage application chain over one [H, W] frame as ONE
        device-resident dispatch.

        ``chain``: ordered stages (DFGs mapped here, pre-mapped configs, or
        library app names); stage i's ``out_channels[i]`` output (default
        channel 0) feeds stage i+1's ingest taps without the intermediate
        leaving the device -- a pipeline plan bound once per distinct chain
        and cached on this instance.  A single-stage chain is just
        :meth:`run_image`.  Conventional mode only; every stage needs an
        ingest plan.  Returns [H, W] (or [num_outputs, H, W]) of the final
        stage.
        """
        if self.mode != "conventional":
            raise RuntimeError(
                "run_pipeline requires mode='conventional' (the "
                "parameterized path specializes a single application per "
                "executable)"
            )
        cfgs = []
        for stage in chain:
            if isinstance(stage, str):
                stage = apps.ALL_APPS[stage]()
            cfgs.append(stage if isinstance(stage, VCGRAConfig) else self.map(stage))
        if not cfgs:
            raise ValueError("chain must name at least one stage")
        for cfg in cfgs:
            if cfg.ingest is None:
                raise ValueError(
                    f"pipeline stage {cfg.app_name!r} has no ingest plan; "
                    f"chains need fused-ingest stages end to end"
                )
        spec = PipelineSpec.chain(cfgs, out_channels)
        if spec.depth == 1:
            self.load(cfgs[0])
            return self.run_image(image)
        fn = self._pipeline_fns.get(spec)
        if fn is None:
            fn = self._compile(OverlayPlan(grid=self.grid, batched=True, pipeline=(spec,),
                                           backend=self.backend, mesh=self.mesh))
            self._pipeline_fns[spec] = fn
        image = self._tensor(image)
        H, W = image.shape
        settings = tuple(
            (
                VCGRAConfig.stack([st.config], device=self.device),
                IngestPlan.stack([st.config.ingest], self.grid.dtype, device=self.device),
                torch.tensor([st.out_channel], dtype=torch.int32, device=self.device),
            )
            for st in spec.stages
        )
        hw = torch.tensor([[H, W]], dtype=torch.int32, device=self.device)
        t0 = time.perf_counter()
        y = fn(settings, hw, image[None])[0]
        _sync(self.device)
        self.timings["run_pipeline_s"] = time.perf_counter() - t0
        return y.reshape((-1, H, W))[0] if y.shape[0] == 1 else y.reshape((-1, H, W))


def sobel_pixie(mode: str = "conventional", data_bits: int = 32, backend: str = "hopper",
                device="cuda") -> Pixie:
    """The paper's demonstrator: Sobel on the 45-PE/4-VC grid (Sec. IV)."""
    return Pixie(gridlib.sobel_grid(data_bits=data_bits), mode=mode, backend=backend,
                 device=device)
