"""A small module layer: the subset of the flax.linen API the networks use.

Modules are dataclasses. A module built inside a bound module's method becomes
its child: it is named by its ``name`` or, failing that, ``<Class>_<n>``, and
its variables live under that name. ``init`` returns the variable collections
(``params``, ``batch_stats``) as nested dicts; ``apply`` runs a method against
them and, with ``mutable=[...]``, also returns the updated collections. The
collections, tree paths and arithmetic follow flax.linen, so variables from
either load into the other (tests/test_module_layer.py compares the two).

Random keys are derived from the root key of a stream, the module path and a
per-module counter, so a parameter's initial value does not depend on the order
in which modules are built.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import threading
import zlib
from typing import Any, Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.nn import initializers, leaky_relu, one_hot, relu, sigmoid, softmax  # noqa: F401
from jax.numpy import tanh  # noqa: F401

__all__ = [
    "Module", "compact", "Dense", "Conv", "ConvTranspose", "BatchNorm",
    "SpectralNorm", "Dropout", "RNN", "OptimizedLSTMCell", "max_pool",
    "avg_pool", "one_hot", "relu", "leaky_relu", "sigmoid", "softmax", "tanh",
    "initializers",
]

default_kernel_init = initializers.lecun_normal()

_context = threading.local()


def _stack() -> list:
    if not hasattr(_context, "modules"):
        _context.modules = []
    return _context.modules


def compact(fn: Callable) -> Callable:
    """Marks the method that builds submodules inline. Every public method of
    a module may build submodules and variables, so this is a no-op kept for
    API compatibility."""
    return fn


class _Root:
    """State of one init/apply call, shared by every scope in it."""

    def __init__(self, variables, rngs, mutable, initializing):
        self.variables = variables
        self.rngs = rngs
        self.mutable = mutable
        self.initializing = initializing

    def is_mutable(self, col: str) -> bool:
        return self.initializing or self.mutable is True or col in self.mutable


class _Scope:
    def __init__(self, root: _Root, path: tuple):
        self.root = root
        self.path = path
        self.autoname = {}
        self.rng_counts = {}
        self.param_transform = None  # set by SpectralNorm around a call

    def child(self, name: str) -> "_Scope":
        return _Scope(self.root, self.path + (name,))

    def _node(self, col: str, create: bool):
        node = self.root.variables.get(col)
        if node is None:
            if not create:
                return None
            node = self.root.variables[col] = {}
        for name in self.path:
            nxt = node.get(name)
            if nxt is None:
                if not create:
                    return None
                nxt = node[name] = {}
            node = nxt
        return node

    def has(self, col: str, name: str) -> bool:
        node = self._node(col, create=False)
        return node is not None and name in node

    def get(self, col: str, name: str):
        node = self._node(col, create=False)
        if node is None or name not in node:
            raise KeyError(f"no variable {col}/{'/'.join(self.path + (name,))}")
        return node[name]

    def put(self, col: str, name: str, value) -> None:
        if not self.root.is_mutable(col):
            raise ValueError(
                f"cannot update {col}/{'/'.join(self.path + (name,))}: the "
                f"collection is not mutable (pass mutable=[{col!r}] to apply)")
        self._node(col, create=True)[name] = value

    def make_rng(self, stream: str) -> jax.Array:
        if stream not in self.root.rngs:
            raise ValueError(f"no {stream!r} key given to init/apply")
        n = self.rng_counts.get(stream, 0)
        self.rng_counts[stream] = n + 1
        tag = zlib.crc32(("/".join(self.path) + f"#{n}").encode())
        return jax.random.fold_in(self.root.rngs[stream], tag)


def _copy_tree(tree):
    return {k: _copy_tree(v) for k, v in tree.items()} if isinstance(tree, dict) else tree


def _bound_method(fn: Callable) -> Callable:
    @functools.wraps(fn)
    def method(self, *args, **kwargs):
        scope = self._scope
        if scope is None:
            raise ValueError(f"{type(self).__name__} is not bound: call it "
                             f"through init() or apply(), or inside a module")
        stack = _stack()
        if not any(m is self for m in stack):  # a new call reuses child names
            scope.autoname = {}
        stack.append(self)
        try:
            if not self._setup_done:
                self._setup_done = True
                self.setup()
            return fn(self, *args, **kwargs)
        finally:
            stack.pop()

    return method


_BASE_METHODS = {"setup", "init", "apply", "param", "variable", "make_rng",
                 "is_initializing", "has_variable"}


class Module:
    """Base class; subclasses are dataclasses (see the module docstring)."""

    _: dataclasses.KW_ONLY
    name: Optional[str] = None

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        fields = vars(cls).get("__annotations__", {})
        for attr, value in list(vars(cls).items()):
            if (inspect.isfunction(value) and attr not in fields
                    and attr not in _BASE_METHODS
                    and (attr == "__call__" or not attr.startswith("_"))):
                setattr(cls, attr, _bound_method(value))
        dataclasses.dataclass(cls, eq=True, unsafe_hash=True, repr=False)

    def __post_init__(self):
        self._scope = None
        self._setup_done = False
        stack = _stack()
        if stack:
            parent = stack[-1]
            if self.name is None:
                prefix = type(self).__name__
                n = parent._scope.autoname.get(prefix, 0)
                parent._scope.autoname[prefix] = n + 1
                self.name = f"{prefix}_{n}"
            self._scope = parent._scope.child(self.name)

    def __repr__(self):
        return f"{type(self).__name__}(name={self.name!r})"

    def setup(self) -> None:
        """Runs once, before the first method call of a bound module."""

    # -------------------------------------------------------------- variables
    def is_initializing(self) -> bool:
        return self._scope.root.initializing

    def has_variable(self, col: str, name: str) -> bool:
        return self._scope.has(col, name)

    def make_rng(self, stream: str = "params") -> jax.Array:
        return self._scope.make_rng(stream)

    def param(self, name: str, init_fn: Callable, *init_args):
        scope = self._scope
        if not scope.has("params", name):
            if not scope.root.initializing:
                raise KeyError(
                    f"missing param {'/'.join(scope.path + (name,))}")
            scope.put("params", name, init_fn(self.make_rng("params"), *init_args))
        value = scope.get("params", name)
        if scope.param_transform is not None:
            value = scope.param_transform(name, value)
        return value

    def variable(self, col: str, name: str, init_fn: Callable, *init_args):
        scope = self._scope
        if not scope.has(col, name):
            scope.put(col, name, init_fn(*init_args))
        return Variable(scope, col, name)

    # ------------------------------------------------------------ entry points
    def _bind(self, root: _Root) -> "Module":
        module = dataclasses.replace(self)
        module._scope = _Scope(root, ())
        return module

    def init(self, rngs, *args, method=None, **kwargs) -> dict:
        if not isinstance(rngs, dict):
            rngs = {"params": rngs}
        root = _Root({}, rngs, True, initializing=True)
        self._run(root, method, args, kwargs)
        return root.variables

    def apply(self, variables, *args, rngs=None, mutable=False, method=None,
              **kwargs):
        if isinstance(mutable, str):
            mutable = [mutable]
        mutable = mutable if mutable is True else set(mutable or ())
        variables = {col: _copy_tree(tree)
                     if (mutable is True or col in mutable) else tree
                     for col, tree in variables.items()}
        root = _Root(variables, dict(rngs or {}), mutable, initializing=False)
        out = self._run(root, method, args, kwargs)
        if not mutable:
            return out
        return out, {col: tree for col, tree in root.variables.items()
                     if mutable is True or col in mutable}

    def _run(self, root, method, args, kwargs):
        module = self._bind(root)
        if method is None:
            fn = module.__call__
        elif isinstance(method, str):
            fn = getattr(module, method)
        else:
            fn = functools.partial(method, module)
        return fn(*args, **kwargs)


class Variable:
    """A handle on one variable of a collection; `.value` reads and writes."""

    def __init__(self, scope: _Scope, col: str, name: str):
        self._scope, self._col, self._name = scope, col, name

    @property
    def value(self):
        return self._scope.get(self._col, self._name)

    @value.setter
    def value(self, v):
        self._scope.put(self._col, self._name, v)


dataclasses.dataclass(Module, eq=True, unsafe_hash=True, repr=False)


def _promote(*xs, dtype=None):
    if dtype is None:
        dtype = jnp.result_type(*(x for x in xs if x is not None))
    return [None if x is None else jnp.asarray(x, dtype) for x in xs]


def _tuple(x, n: int) -> tuple:
    if x is None:
        return (1,) * n
    if isinstance(x, int):
        return (x,) * n
    return tuple(x)


# ------------------------------------------------------------------ layers
class Dense(Module):
    features: int
    use_bias: bool = True
    dtype: Any = None
    param_dtype: Any = jnp.float32
    kernel_init: Callable = default_kernel_init
    bias_init: Callable = initializers.zeros

    def __call__(self, inputs):
        kernel = self.param("kernel", self.kernel_init,
                            (inputs.shape[-1], self.features), self.param_dtype)
        bias = (self.param("bias", self.bias_init, (self.features,),
                           self.param_dtype) if self.use_bias else None)
        inputs, kernel, bias = _promote(inputs, kernel, bias, dtype=self.dtype)
        y = lax.dot_general(inputs, kernel, (((inputs.ndim - 1,), (0,)), ((), ())))
        if bias is not None:
            y += jnp.reshape(bias, (1,) * (y.ndim - 1) + (-1,))
        return y


class Conv(Module):
    """2-D channels-last (NHWC) convolution; kernel (kh, kw, in, features)."""

    features: int
    kernel_size: Sequence[int] = (3, 3)
    strides: Any = 1
    padding: str = "SAME"
    use_bias: bool = True
    dtype: Any = None
    param_dtype: Any = jnp.float32
    kernel_init: Callable = default_kernel_init
    bias_init: Callable = initializers.zeros

    def __call__(self, inputs):
        ks = tuple(self.kernel_size)
        kernel = self.param("kernel", self.kernel_init,
                            ks + (inputs.shape[-1], self.features), self.param_dtype)
        bias = (self.param("bias", self.bias_init, (self.features,),
                           self.param_dtype) if self.use_bias else None)
        inputs, kernel, bias = _promote(inputs, kernel, bias, dtype=self.dtype)
        y = lax.conv_general_dilated(
            inputs, kernel, _tuple(self.strides, len(ks)), self.padding,
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        if bias is not None:
            y += bias.reshape((1,) * (y.ndim - 1) + (-1,))
        return y


class ConvTranspose(Module):
    """2-D channels-last transposed convolution, as `lax.conv_transpose`."""

    features: int
    kernel_size: Sequence[int] = (3, 3)
    strides: Any = None
    padding: str = "SAME"
    use_bias: bool = True
    dtype: Any = None
    param_dtype: Any = jnp.float32
    kernel_init: Callable = default_kernel_init
    bias_init: Callable = initializers.zeros

    def __call__(self, inputs):
        ks = tuple(self.kernel_size)
        kernel = self.param("kernel", self.kernel_init,
                            ks + (inputs.shape[-1], self.features), self.param_dtype)
        bias = (self.param("bias", self.bias_init, (self.features,),
                           self.param_dtype) if self.use_bias else None)
        inputs, kernel, bias = _promote(inputs, kernel, bias, dtype=self.dtype)
        y = lax.conv_transpose(inputs, kernel, _tuple(self.strides, len(ks)),
                               self.padding)
        if bias is not None:
            y += jnp.reshape(bias, (1,) * (y.ndim - 1) + (-1,))
        return y


class BatchNorm(Module):
    """Batch norm over every axis but the last; running statistics in the
    ``batch_stats`` collection, left untouched while initializing."""

    use_running_average: Optional[bool] = None
    momentum: float = 0.99
    epsilon: float = 1e-5
    dtype: Any = None
    use_bias: bool = True
    use_scale: bool = True
    bias_init: Callable = initializers.zeros
    scale_init: Callable = initializers.ones

    def __call__(self, x, use_running_average: Optional[bool] = None):
        if use_running_average is None:
            use_running_average = self.use_running_average
        reduction_axes = tuple(range(x.ndim - 1))
        feature_shape = (x.shape[-1],)
        ra_mean = self.variable("batch_stats", "mean",
                                lambda s: jnp.zeros(s, jnp.float32), feature_shape)
        ra_var = self.variable("batch_stats", "var",
                               lambda s: jnp.ones(s, jnp.float32), feature_shape)
        if use_running_average:
            mean, var = ra_mean.value, ra_var.value
        else:
            stat_dtype = jnp.promote_types(
                self.dtype or jnp.result_type(x), jnp.float32)
            x32 = x.astype(stat_dtype)
            mean = x32.mean(reduction_axes)
            mean2 = lax.square(x32).mean(reduction_axes)
            var = jnp.maximum(0.0, mean2 - lax.square(mean))
            if not self.is_initializing():
                ra_mean.value = self.momentum * ra_mean.value + (1 - self.momentum) * mean
                ra_var.value = self.momentum * ra_var.value + (1 - self.momentum) * var
        bshape = (1,) * (x.ndim - 1) + feature_shape
        y = x - jnp.reshape(mean, bshape)
        mul = lax.rsqrt(jnp.reshape(var, bshape) + self.epsilon)
        args = [x]
        if self.use_scale:
            scale = self.param("scale", self.scale_init, feature_shape,
                               jnp.float32).reshape(bshape)
            mul *= scale
            args.append(scale)
        y *= mul
        if self.use_bias:
            bias = self.param("bias", self.bias_init, feature_shape,
                              jnp.float32).reshape(bshape)
            y += bias
            args.append(bias)
        dtype = self.dtype or jnp.result_type(*args)
        return jnp.asarray(y, dtype)


def _l2_normalize(x, eps: float = 1e-12):
    return x * lax.rsqrt((x * x).sum(keepdims=True) + eps)


class SpectralNorm(Module):
    """Wraps a layer so each of its matrix params is divided by its largest
    singular value, estimated by power iteration from a persistent vector
    ``u`` (and the estimate ``sigma``) kept in ``batch_stats`` under
    ``<layer name>/<param>/u``."""

    layer_instance: Module

    def __call__(self, *args, update_stats: bool, **kwargs):
        layer = self.layer_instance
        layer._scope.param_transform = functools.partial(
            self._normalize, layer.name, update_stats=update_stats)
        try:
            return layer(*args, **kwargs)
        finally:
            layer._scope.param_transform = None

    def _normalize(self, layer_name, param_name, value, update_stats):
        value = jnp.asarray(value)
        shape = value.shape
        if value.ndim <= 1:
            return value
        mat = jnp.reshape(value, (-1, shape[-1]))
        prefix = f"{layer_name}/{param_name}"
        u_var = self.variable(
            "batch_stats", prefix + "/u", jax.random.normal,
            None if self.has_variable("batch_stats", prefix + "/u")
            else self.make_rng("params"),
            (1, mat.shape[-1]), jnp.float32)
        sigma_var = self.variable("batch_stats", prefix + "/sigma", jnp.ones, (),
                                  jnp.float32)
        # one power-iteration step per call
        v0 = _l2_normalize(jnp.matmul(u_var.value, mat.transpose([1, 0])))
        u0 = _l2_normalize(jnp.matmul(v0, mat))
        u0 = lax.stop_gradient(u0)
        v0 = lax.stop_gradient(v0)
        sigma = jnp.matmul(jnp.matmul(v0, mat), jnp.transpose(u0))[0, 0]
        mat = mat / jnp.where(sigma != 0, sigma, 1)
        if update_stats:
            u_var.value = u0
            sigma_var.value = sigma
        return mat.reshape(shape).astype(jnp.result_type(value, u0, sigma))


class Dropout(Module):
    rate: float
    deterministic: Optional[bool] = None

    def __call__(self, inputs, deterministic: Optional[bool] = None):
        if deterministic is None:
            deterministic = self.deterministic
        if self.rate == 0.0 or deterministic:
            return inputs
        if self.rate == 1.0:
            return jnp.zeros_like(inputs)
        keep = 1.0 - self.rate
        mask = jax.random.bernoulli(self.make_rng("dropout"), keep, inputs.shape)
        return lax.select(mask, inputs / keep, jnp.zeros_like(inputs))


# ---------------------------------------------------------------- recurrent
class _DenseParams(Module):
    features: int
    use_bias: bool
    kernel_init: Callable

    def __call__(self, in_features: int):
        kernel = self.param("kernel", self.kernel_init, (in_features, self.features))
        bias = (self.param("bias", initializers.zeros, (self.features,))
                if self.use_bias else None)
        return kernel, bias


class OptimizedLSTMCell(Module):
    """LSTM cell whose four gate matmuls run as one per operand; params
    ``i{i,f,g,o}/kernel`` and ``h{i,f,g,o}/{kernel,bias}``; f32 params and
    carry, computed in the promoted dtype of inputs and params."""

    features: int

    def params_for(self, in_features: int) -> dict:
        out = {}
        for c in "ifgo":
            out["i" + c] = _DenseParams(self.features, False, default_kernel_init,
                                        name="i" + c)(in_features)
            out["h" + c] = _DenseParams(self.features, True, initializers.orthogonal(),
                                        name="h" + c)(self.features)
        return out

    def step(self, params: dict, carry, inputs):
        """One time step from explicit params (safe inside lax.scan)."""
        c, h = carry

        def concat_dense(x, prefix, use_bias):
            parts = [params[prefix + g] for g in "ifgo"]
            kernel = jnp.concatenate([k for k, _ in parts], axis=-1)
            bias = (jnp.concatenate([b for _, b in parts], axis=-1)
                    if use_bias else None)
            x, kernel, bias = _promote(x, kernel, bias)
            y = jnp.dot(x, kernel)
            if use_bias:
                y += jnp.reshape(bias, (1,) * (y.ndim - 1) + (-1,))
            return jnp.split(y, 4, axis=-1)

        hi, hf, hg, ho = concat_dense(h, "h", True)
        ii, if_, ig, io = concat_dense(inputs, "i", False)
        i = sigmoid(hi + ii)
        f = sigmoid(hf + if_)
        g = jnp.tanh(hg + ig)
        o = sigmoid(ho + io)
        new_c = f * c + i * g
        new_h = o * jnp.tanh(new_c)
        return (new_c, new_h), new_h


class RNN(Module):
    """Runs a cell over axis 1 of (batch, time, features) inputs."""

    cell: Module
    reverse: bool = False
    keep_order: bool = False

    def __call__(self, inputs):
        params = self.cell.params_for(inputs.shape[-1])
        zeros = jnp.zeros(inputs.shape[:1] + (self.cell.features,), jnp.float32)
        xs = jnp.swapaxes(inputs, 0, 1)
        if self.reverse:
            xs = xs[::-1]
        _, ys = lax.scan(lambda carry, x: self.cell.step(params, carry, x),
                         (zeros, zeros), xs)
        if self.reverse and self.keep_order:
            ys = ys[::-1]
        return jnp.swapaxes(ys, 0, 1)


# ------------------------------------------------------------------ pooling
def _pool(inputs, init, reduce_fn, window_shape, strides, padding):
    n_batch = inputs.ndim - (len(window_shape) + 1)
    strides = tuple(strides or (1,) * len(window_shape))
    dims = (1,) * n_batch + tuple(window_shape) + (1,)
    strides = (1,) * n_batch + strides + (1,)
    if not isinstance(padding, str):
        padding = ((0, 0),) * n_batch + tuple(map(tuple, padding)) + ((0, 0),)
    return lax.reduce_window(inputs, init, reduce_fn, dims, strides, padding)


def max_pool(inputs, window_shape, strides=None, padding="VALID"):
    return _pool(inputs, -jnp.inf, lax.max, window_shape, strides, padding)


def avg_pool(inputs, window_shape, strides=None, padding="VALID"):
    """Window mean, padded cells counted (flax's count_include_pad=True)."""
    y = _pool(inputs, 0.0, lax.add, window_shape, strides, padding)
    return y / np.prod(window_shape)
