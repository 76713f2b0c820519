"""Port parity: tensor parallelism (the Megatron block, the `tensor_parallel`
and `tp_fsdp` placements, the trainer on a `tensor` axis).

Single-process cases run T = 2 tensor ranks as two threads of this process
on a stand-in for the `tensor` process group (`_ThreadGroup`): its
all-reduce sums (or takes the max of) the two ranks' tensors by hand, in
rank order, and its all-gather concatenates them. Each rank's module holds
its block of the weights (`sharding.infer_sharding(..., "tensor_parallel")`
on a layout-only mesh); its output and the gradients, the sharded leaves'
put together along their sharded dim, are held against the unsplit port
and against the JAX module on the same weights, at width 64, 4 heads of
16, mlp 128:

  - `Block` (AdaLN) under "pallas" (JAX: "pallas_interpret"),
    "pallas_fused" (JAX: "pallas_fused_interpret"), "xla", "flax" and
    `quant="int8_all"`; with injected dropout masks against the unsplit
    port (which tests/test_torch_model_settings_step.py holds to JAX's
    masks); the depth-2 `Encoder` under `scan=True` with "save_attn".
    Bounds relative to the largest magnitude of what is compared, as
    tests/test_torch_models.py's `TOL` (f32: 1e-5, the same arithmetic in
    another summation order, for the forward and for the gradients against
    the unsplit port's; 1e-4 for the gradients against JAX's, whose own
    sums differ from the unsplit port's by about as much as the ranks'
    do, up to 1.2e-6 of a leaf's largest gradient; a leaf's scale is at
    least 1e-2 of the module's largest gradient, as
    tests/test_torch_train_step.py floors it); int8 against JAX's int8 with
    tests/test_torch_quant.py's model bound (2e-2: the port's f32 rescale
    of an exact int32 sum against XLA's, where a value near a rounding tie
    of its quantization may land on the other integer).
  - int8's scales: the row-split layers quantize with the group's absmax;
    without that reduction the ranks' sum is measurably off the one
    process's (the reduction is what makes it agree).
  - K6's plain version with non-square projections (a tensor rank's 2 of
    4 heads of 16 at width 64 on the CPU; 6 of 12 heads of 64 at width
    768 is the card's) against `mha_reference`, and its two ranks' partial
    products plus the bias against the unsplit K6's plain version.

The trainer's placements on a `tensor` axis against JAX's are in
tests/test_torch_parallel.py; the 4-process cases in
tests/test_torch_tensor_parallel_multiproc.py.
"""

import copy
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_vision_tpu.models import vit as jvit
from small_vision_tpu_torch import convert
from small_vision_tpu_torch.configs import ae_i1k
from small_vision_tpu_torch.models import vit as tvit
from small_vision_tpu_torch.ops import fused_block as tfb
from small_vision_tpu_torch.parallel import collectives
from small_vision_tpu_torch.parallel import ctx
from small_vision_tpu_torch.parallel import mesh as mesh_lib
from small_vision_tpu_torch.parallel import sharding
from small_vision_tpu_torch.utils.trees import tree_flatten_with_names

T = 2
WIDTH, HEADS, MLP = 64, 4, 128
FWD, GRAD, GRAD_JAX = 1e-5, 1e-5, 1e-4
INT8 = 2e-2


class _ThreadGroup:
  """The `tensor` group of T ranks that are threads of one process."""

  def __init__(self, n):
    self.n = n
    self.barrier = threading.Barrier(n, timeout=60)
    self.slots = [None] * n

  def exchange(self, rank, t):
    """Every rank's `t`, in rank order, once all have arrived."""
    self.barrier.wait()
    self.slots[rank] = t.detach().clone()
    self.barrier.wait()
    got = list(self.slots)
    self.barrier.wait()
    return got


class _Rank:
  """A rank's handle on a `_ThreadGroup`: what the model takes as `tp`."""

  def __init__(self, shared, rank):
    self.shared, self.rank = shared, rank


@pytest.fixture
def thread_groups(monkeypatch):
  """Routes the collectives of a `_Rank` to its thread group; the rest go
  to the real functions."""
  orig = {n: getattr(collectives, n) for n in
          ("group_size", "group_rank", "all_reduce", "all_gather")}

  def group_size(g):
    return g.shared.n if isinstance(g, _Rank) else orig["group_size"](g)

  def group_rank(g):
    return g.rank if isinstance(g, _Rank) else orig["group_rank"](g)

  def all_reduce(t, g, op="sum"):
    if not isinstance(g, _Rank):
      return orig["all_reduce"](t, g, op)
    parts = g.shared.exchange(g.rank, t)
    total = parts[0].clone()
    for p in parts[1:]:
      total = torch.maximum(total, p) if op == "max" else total + p
    if op == "mean":
      total = total / len(parts)
    t.copy_(total)
    return t

  def all_gather(x, g, dim=0):
    if not isinstance(g, _Rank):
      return orig["all_gather"](x, g, dim)
    return torch.cat(g.shared.exchange(g.rank, x.contiguous()), dim)

  for name, fn in (("group_size", group_size), ("group_rank", group_rank),
                   ("all_reduce", all_reduce), ("all_gather", all_gather)):
    monkeypatch.setattr(collectives, name, fn)
  local = threading.local()
  monkeypatch.setattr(ctx, "tensor_group", lambda: getattr(local, "tp", None))
  return local


def run_ranks(local, fn, n=T):
  """fn(rank, tp) in n threads on one `_ThreadGroup`; their results."""
  shared = _ThreadGroup(n)
  out, errors = [None] * n, []

  def body(rank):
    local.tp = _Rank(shared, rank)
    try:
      out[rank] = fn(rank, local.tp)
    except BaseException as e:  # noqa: BLE001 (re-raised below)
      errors.append(e)
      shared.barrier.abort()

  threads = [threading.Thread(target=body, args=(r,)) for r in range(n)]
  for th in threads:
    th.start()
  for th in threads:
    th.join()
  if errors:
    raise errors[0]
  return out


def _close(got, want, rel, what="", floor=1e-30):
  """max |got - want| within `rel` of max |want|, or of `floor` where
  that is larger."""
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  err = np.max(np.abs(got - want))
  assert err <= rel * max(np.max(np.abs(want)), floor), (
      what, err, np.max(np.abs(want)))


def _floor(grads):
  """A gradient leaf's least scale: 1e-2 of the module's largest
  gradient. The key biases' gradient is 0 analytically (softmax does not
  see a shift of all of a query's scores), so theirs is round-off."""
  return 1e-2 * max(float(np.max(np.abs(np.asarray(g))))
                    for g in grads.values())


def _config(attn_impl="pallas", quant="none", dropout=0.0, scan=False):
  config = ae_i1k.get_config("runlocal,size=16")
  config["model"].update(width=WIDTH, num_heads=HEADS, mlp_dim=MLP,
                         dtype_mm="float32", attn_impl=attn_impl,
                         quant=quant, dropout=dropout, scan=scan)
  return config


_MESH = mesh_lib.make_mesh(T, tensor=T)  # a layout: shapes and coordinates


def _rank_copy(module, prefix, rank):
  """A copy of `module` holding tensor rank `rank`'s block of each leaf the
  `tensor_parallel` rules shard (`prefix` makes the flax names)."""
  part = copy.deepcopy(module)
  named = {f"{prefix}{n.replace('.', '/')}": p
           for n, p in part.named_parameters()}
  specs = sharding.infer_sharding(named, _MESH, "tensor_parallel")
  with torch.no_grad():
    for name, p in named.items():
      p.data = sharding.shard_of(p.data, specs[name], _MESH,
                                 rank).contiguous()
  return part, {n: specs[f"{prefix}{n.replace('.', '/')}"]
                for n, _ in part.named_parameters()}


def _grads(module, inputs, out_fn):
  """(output, {name: grad}, [input grads]) of sum(output * seeded g)."""
  inputs = [x.detach().clone().requires_grad_(True) for x in inputs]
  y = out_fn(module, inputs)
  g = torch.from_numpy(np.random.default_rng(9).standard_normal(
      tuple(y.shape)).astype(np.float32))
  names = [n for n, _ in module.named_parameters()]
  grads = torch.autograd.grad((y * g).sum(), [
      p for _, p in module.named_parameters()] + inputs)
  return (y.detach(), dict(zip(names, grads[:len(names)])),
          list(grads[len(names):]), g)


def _tp_grads(local, module, prefix, inputs, out_fn):
  """The ranks' outputs and their gradients put together: a sharded
  leaf's along its dim, a replicated leaf's must be the same on each."""
  def one(rank, tp):
    part, specs = _rank_copy(module, prefix, rank)
    return _grads(part, inputs, lambda m, xs: out_fn(m, xs, tp)), specs
  (r0, specs), (r1, _) = run_ranks(local, one)
  torch.testing.assert_close(r0[0], r1[0], rtol=0, atol=0)  # one output
  grads = {}
  for name, spec in specs.items():
    hit = sharding.spec_axis(spec)
    if hit is None:
      torch.testing.assert_close(r0[1][name], r1[1][name], rtol=0, atol=0,
                                 msg=name)
      grads[name] = r0[1][name]
    else:
      grads[name] = torch.cat([r0[1][name], r1[1][name]], hit[0])
  for a, b in zip(r0[2], r1[2]):
    torch.testing.assert_close(a, b, rtol=0, atol=0)
  return r0[0], grads, r0[2]


def _block_inputs():
  rng = np.random.default_rng(0)
  x = torch.from_numpy(rng.standard_normal((2, 20, WIDTH)).astype(np.float32))
  cond = torch.from_numpy(rng.standard_normal((2, WIDTH)).astype(np.float32))
  return x, cond


def _jax_block_grads(config, params, x, cond, g):
  kw = dict(config["model"])
  impl = kw["attn_impl"]
  if impl.startswith("pallas"):
    impl += "_interpret"
  block = jvit.Block(mlp_dim=MLP, num_heads=HEADS, adaln=True,
                     dtype_mm="float32", attn_impl=impl,
                     quant=kw["quant"])
  fn = lambda p, x, c: block.apply({"params": p}, x, c)[0]
  y, vjp = jax.vjp(fn, params, jnp.asarray(x.numpy()),
                   jnp.asarray(cond.numpy()))
  gp, gx, gc = vjp(jnp.asarray(g.numpy()))
  return np.asarray(y), dict(tree_flatten_with_names(jax.device_get(gp))), [
      np.asarray(gx), np.asarray(gc)]


BLOCK_CASES = {"pallas": dict(), "pallas_fused": dict(attn_impl="pallas_fused"),
               "xla": dict(attn_impl="xla"), "flax": dict(attn_impl="flax"),
               "int8_all": dict(quant="int8_all")}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_megatron_block_matches_unsplit_and_jax(thread_groups, case):
  config = _config(**BLOCK_CASES[case])
  params = convert.init_params(config, seed=1)["Encoder"]["blocks_00"]
  kw = dict(config["model"])
  block = tvit.Block(WIDTH, MLP, HEADS, True, torch.float32,
                     kw["attn_impl"], kw["quant"])
  block.load_state_dict(convert.params_from_jax(params, block))
  x, cond = _block_inputs()
  run = lambda m, xs, tp=None: m(xs[0], xs[1], tp=tp)
  y1, g1, gin1, g = _grads(block, (x, cond), run)
  y, grads, gin = _tp_grads(thread_groups, block, "Encoder/blocks_00/",
                            (x, cond), run)
  jy, jgrads, jgin = _jax_block_grads(config, params, x, cond, g)
  int8 = case == "int8_all"
  _close(y, y1, FWD, "forward vs unsplit")
  _close(y, jy, INT8 if int8 else FWD, "forward vs JAX")
  floor = _floor(g1)
  for name, want in g1.items():
    _close(grads[name], want, GRAD, name, floor)
    _close(grads[name], jgrads[name.replace(".", "/")],
           INT8 if int8 else GRAD_JAX, f"{name} vs JAX", floor)
  for a, b, c in zip(gin, gin1, jgin):
    _close(a, b, GRAD, "input")
    _close(a, c, INT8 if int8 else GRAD_JAX, "input vs JAX")


@pytest.mark.parametrize("module", ["MultiHeadAttention_0", "MlpBlock_0"])
@pytest.mark.parametrize("attn_impl", ["pallas", "pallas_fused"])
def test_megatron_halves_sum_to_the_unsplit_module(thread_groups, module,
                                                   attn_impl):
  """Each half alone: the ranks' summed output and gradients against the
  unsplit module's."""
  config = _config(attn_impl)
  params = convert.init_params(config, seed=2)["Encoder"]["blocks_00"]
  block = tvit.Block(WIDTH, MLP, HEADS, True, torch.float32, attn_impl)
  block.load_state_dict(convert.params_from_jax(params, block))
  half = getattr(block, module)
  x, _ = _block_inputs()
  run = lambda m, xs, tp=None: m(xs[0], tp=tp)
  y1, g1, gin1, _ = _grads(half, (x,), run)
  y, grads, gin = _tp_grads(thread_groups, half,
                            f"Encoder/blocks_00/{module}/", (x,), run)
  _close(y, y1, FWD, module)
  for name, want in g1.items():
    _close(grads[name], want, GRAD, name, _floor(g1))
  _close(gin[0], gin1[0], GRAD, "input")


def test_megatron_block_with_injected_dropout_masks(thread_groups):
  """Dropout 0.1 with the three masks given: the MLP's (B, L, hidden) mask
  is sliced to each rank's hidden units, the branches' stay whole."""
  config = _config(dropout=0.1)
  params = convert.init_params(config, seed=3)["Encoder"]["blocks_00"]
  block = tvit.Block(WIDTH, MLP, HEADS, True, torch.float32, dropout=0.1)
  block.load_state_dict(convert.params_from_jax(params, block))
  x, cond = _block_inputs()
  gen = torch.Generator().manual_seed(4)
  drops = block.draw_masks(
      lambda shape: torch.rand(shape, generator=gen) < 0.9, 2, 20)
  assert drops[1].shape == (2, 20, MLP) and not drops[1].all()
  run = lambda m, xs, tp=None: m(xs[0], xs[1], drops, tp=tp)
  y1, g1, gin1, _ = _grads(block, (x, cond), run)
  y, grads, gin = _tp_grads(thread_groups, block, "Encoder/blocks_00/",
                            (x, cond), run)
  _close(y, y1, FWD, "forward")
  for name, want in g1.items():
    _close(grads[name], want, GRAD, name, _floor(g1))
  for a, b in zip(gin, gin1):
    _close(a, b, GRAD, "input")


def test_megatron_scan_encoder_with_save_attn(thread_groups):
  """The depth-2 stacked Encoder under "save_attn" (attn_out saved, the
  rest recomputed in the backward, its collectives again): the ranks'
  output and gradients against the unsplit Encoder's and JAX's."""
  config = _config(scan=True)
  full = convert.init_params(config, seed=5)
  params = full["Encoder"]
  enc = tvit.Encoder(2, WIDTH, MLP, HEADS, True, torch.float32,
                     scan=True, remat_policy="save_attn")
  enc.load_state_dict(convert.params_from_jax(params, enc))
  x, cond = _block_inputs()
  run = lambda m, xs, tp=None: m(xs[0], xs[1])
  y1, g1, gin1, g = _grads(enc, (x, cond), run)
  y, grads, gin = _tp_grads(thread_groups, enc, "Encoder/", (x, cond), run)
  jenc = jvit.Encoder(depth=2, mlp_dim=MLP, num_heads=HEADS, adaln=True,
                      scan=True, remat_policy="save_attn",
                      dtype_mm="float32", attn_impl="pallas_interpret")
  fn = lambda p, x, c: jenc.apply({"params": p}, x, c)
  jy, vjp = jax.vjp(fn, params, jnp.asarray(x.numpy()),
                    jnp.asarray(cond.numpy()))
  jgp, jgx, jgc = vjp(jnp.asarray(g.numpy()))
  jgp = dict(tree_flatten_with_names(jax.device_get(jgp)))
  _close(y, y1, FWD, "forward")
  _close(y, jy, FWD, "forward vs JAX")
  floor = _floor(g1)
  for name, want in g1.items():
    _close(grads[name], want, GRAD, name, floor)
    _close(grads[name], jgp[name.replace(".", "/")], GRAD_JAX, name, floor)
  for a, b, c in zip(gin, gin1, (jgx, jgc)):
    _close(a, b, GRAD, "input")
    _close(a, c, GRAD_JAX, "input vs JAX")


def test_int8_row_split_scales_are_the_groups(thread_groups):
  """`Dense_1`'s int8 product on two ranks' halves of the hidden width:
  with the group's absmax (the max over the ranks) the ranks' sum is the
  one process's product to f32 rounding; with each rank's own absmax it
  is not."""
  from small_vision_tpu_torch.ops import quant
  rng = np.random.default_rng(6)
  h = torch.from_numpy(rng.standard_normal((40, MLP)).astype(np.float32))
  h[:, MLP // 2:] *= 4  # the ranks' absmax differ
  w = torch.from_numpy(rng.standard_normal((MLP, WIDTH)).astype(np.float32))
  want = quant.int8_matmul(h, w)

  def part(rank, tp, group):
    sl = slice(rank * MLP // T, (rank + 1) * MLP // T)
    return quant.int8_matmul(h[:, sl], w[sl], group(tp))
  shared = sum(run_ranks(thread_groups, lambda r, tp: part(r, tp, lambda g: g)))
  alone = sum(run_ranks(thread_groups, lambda r, tp: part(r, tp,
                                                          lambda g: None)))
  _close(shared, want, 1e-6, "group scales")
  err = float((alone - want).abs().max() / want.abs().max())
  assert err > 1e-3, err


def test_fused_mha_plain_non_square_matches_the_reference():
  """K6's plain version on a rank's 2 of 4 heads (64 -> 32 -> 64) against
  `mha_reference` (the packed attention, whose clamped exp2 softmax is
  not the max-shift one: 1e-5 of the output's magnitude), and the two
  ranks' partial products plus the bias against the unsplit plain K6."""
  rng = np.random.default_rng(7)
  f = lambda *s, std=1.0: torch.from_numpy(
      (rng.standard_normal(s) * std).astype(np.float32))
  x = f(2, 20, WIDTH)
  w = {n: f(WIDTH, WIDTH, std=WIDTH ** -0.5) for n in ("q", "k", "v", "o")}
  b = {n: f(WIDTH, std=0.1) for n in ("q", "k", "v", "o")}
  whole = tfb.fused_mha_plain(x, w["q"], b["q"], w["k"], b["k"], w["v"],
                              b["v"], w["o"], b["o"], HEADS)
  total = 0
  for r in range(T):
    cols = slice(r * WIDTH // T, (r + 1) * WIDTH // T)
    args = (x, w["q"][:, cols], b["q"][cols], w["k"][:, cols], b["k"][cols],
            w["v"][:, cols], b["v"][cols], w["o"][cols],
            torch.zeros(WIDTH), HEADS // T)
    got = tfb.fused_mha_plain(*args)
    assert got.shape == (2, 20, WIDTH)
    _close(got, tfb.mha_reference(*args), 1e-5, f"rank {r}")
    total = total + got
  _close(total + b["o"], whole, 1e-6, "ranks' sum")
