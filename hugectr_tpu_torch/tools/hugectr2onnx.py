"""Checkpoint -> ONNX converter.

Analog of the reference onnx_converter (onnx_converter/hugectr2onnx/
converter.py:22 `convert`, graph_builder.py:44-1611 per-layer switch): loads
a graph JSON (Model.graph_to_json) plus a snapshot dir
(Model.download_params_to_files) and emits an inference ONNX model via the
dependency-free writer (onnx_writer.py).

Inference semantics follow the reference converter: Dropout becomes
Identity, the final loss layer becomes a Sigmoid/Softmax output, embedding
lookups become Gather + pooling over table initializers. Padding keys (-1)
are clamped to row 0 — exported models expect dense (non-padded) inputs like
the reference's converted models.

The port's own copy of hugectr_tpu/tools/hugectr2onnx.py (numpy only, no torch), kept so that
the port imports nothing of the JAX package; its outputs are the JAX
module's, byte for byte.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from .onnx_writer import INT64, OnnxGraph

__all__ = ["convert"]


class _Converter:
    def __init__(
        self,
        graph: dict,
        snapshot_dir: str,
        batch: Optional[int],
        dense_npz: Optional[str] = None,
        sparse_dirs: Optional[Dict[str, str]] = None,
        convert_embedding: bool = True,
    ):
        self.graph = graph
        self.snap = snapshot_dir
        self.sparse_dirs = sparse_dirs or {}
        self.convert_embedding = convert_embedding
        self.batch = batch or "N"
        self.g = OnnxGraph(name=graph.get("solver", {}).get("model_name") or "model")
        data = np.load(dense_npz or os.path.join(snapshot_dir, "dense_model.npz"))
        self.dense: Dict[str, np.ndarray] = {k: data[k] for k in data.files}
        self.shapes: Dict[str, tuple] = {}

    def _table_dir(self, dirname: str) -> str:
        """Resolve a sparse-model dir: explicit sparse_models entries win
        over the snapshot-dir layout (reference converter takes them as a
        separate list)."""
        name = dirname[len("sparse_"):] if dirname.startswith("sparse_") else dirname
        if name in self.sparse_dirs:
            return self.sparse_dirs[name]
        if dirname in self.sparse_dirs:
            return self.sparse_dirs[dirname]
        return os.path.join(self.snap, dirname)

    # ------------------------------------------------------------- helpers
    def w(self, layer_idx: int, pname: str) -> np.ndarray:
        # dense params saved as dense/<layer_name>/<param>; layer_name is
        # l{idx}_{type}
        for k, v in self.dense.items():
            parts = k.split("/")
            if (
                len(parts) == 3
                and parts[0] == "dense"
                and parts[1].startswith(f"l{layer_idx}_")
                and parts[2] == pname
            ):
                return v
        raise KeyError(f"param {pname} of layer {layer_idx}")

    def init_const(self, name: str, arr: np.ndarray) -> str:
        return self.g.add_initializer(self.g.uname(name), np.asarray(arr))

    # ------------------------------------------------------------ embedding
    def build_embeddings(self):
        inp = self.graph["input"]
        b = self.batch
        # dense + label inputs
        self.g.add_input(inp["dense_name"], [b, inp["dense_dim"]])
        self.shapes[inp["dense_name"]] = (b, inp["dense_dim"])
        feats = {
            p["top_name"]: p for p in inp["data_reader_sparse_param_array"]
        }

        def feat_hotness(p):
            nnz = p["nnz_per_slot"]
            per = nnz if isinstance(nnz, list) else [nnz] * p["slot_num"]
            return per

        key_inputs = {}
        for name, p in feats.items():
            tot = sum(feat_hotness(p))
            if self.convert_embedding:
                # without embeddings the keys never enter the graph — the
                # embedding outputs themselves become the model inputs
                self.g.add_input(name, [b, tot], INT64)
            key_inputs[name] = tot

        # embedding collections
        for e in self.graph.get("embedding_collections", []):
            if not self.convert_embedding:
                # reference convert_embedding=False: the ONNX graph starts
                # at the embedding outputs — declare each lookup top as a
                # model input sized from the graph config
                evs = {t["name"]: t["ev_size"] for t in e.get("tables", [])}
                widths: Dict[str, int] = {}
                for lk in e["lookups"]:
                    ev = evs[lk["table"]]
                    w = (
                        key_inputs[lk["bottom_name"]] * ev
                        if lk["combiner"] == "concat"
                        else ev
                    )
                    widths[lk["top_name"]] = widths.get(lk["top_name"], 0) + w
                for top, w in widths.items():
                    self.g.add_input(top, [b, w])
                    self.shapes[top] = (b, w)
                continue
            tops: Dict[str, List[str]] = {}
            for lk in e["lookups"]:
                tdir = self._table_dir(f"sparse_{lk['table']}")
                table = np.load(os.path.join(tdir, "emb_vector.npy"))
                tname = self.init_const(f"table_{lk['table']}", table)
                keys = lk["bottom_name"]
                gath = self.g.uname("emb_gather")
                self.g.add_node("Gather", [tname, keys], [gath], axis=0)
                ev = table.shape[1]
                comb = lk["combiner"]
                pooled = self.g.uname("emb_pool")
                if comb == "concat":
                    hot = key_inputs[keys]
                    shp = self.init_const(
                        "shape", np.asarray([0, hot * ev], np.int64)
                    )
                    self.g.add_node(
                        "Reshape", [gath, shp], [pooled], allowzero=0
                    )
                    width = hot * ev
                elif comb == "mean":
                    self.g.add_node(
                        "ReduceMean", [gath], [pooled], axes=[1], keepdims=0
                    )
                    width = ev
                else:  # sum
                    ax = self.init_const("axes", np.asarray([1], np.int64))
                    self.g.add_node("ReduceSum", [gath, ax], [pooled], keepdims=0)
                    width = ev
                tops.setdefault(lk["top_name"], []).append((pooled, width))
            for top, parts in tops.items():
                if len(parts) == 1:
                    self.g.add_node("Identity", [parts[0][0]], [top])
                    self.shapes[top] = (b, parts[0][1])
                else:
                    self.g.add_node(
                        "Concat", [p[0] for p in parts], [top], axis=1
                    )
                    self.shapes[top] = (b, sum(p[1] for p in parts))

        # legacy sparse embeddings: [B, slots, ev] tops
        for se in self.graph.get("sparse_embeddings", []):
            if not self.convert_embedding:
                p = feats[se["bottom_name"]]
                ev = se.get("embedding_vec_size")
                top = se["sparse_embedding_name"]
                self.g.add_input(top, [b, p["slot_num"], ev])
                self.shapes[top] = (b, p["slot_num"], ev)
                continue
            tdir = self._table_dir(
                f"sparse_sparse_table_{se['sparse_embedding_name']}"
            )
            table = np.load(os.path.join(tdir, "emb_vector.npy"))
            tname = self.init_const("table", table)
            p = feats[se["bottom_name"]]
            per = feat_hotness(p)
            slots = p["slot_num"]
            ev = table.shape[1]
            offsets = np.concatenate(
                [[0], np.cumsum(se.get("slot_size_array") or [])]
            )[:slots]
            pooled_slots = []
            col = 0
            for si, nnz in enumerate(per):
                sl = self.g.uname("slot_keys")
                st = self.init_const("starts", np.asarray([col], np.int64))
                en = self.init_const("ends", np.asarray([col + nnz], np.int64))
                ax = self.init_const("sax", np.asarray([1], np.int64))
                self.g.add_node("Slice", [se["bottom_name"], st, en, ax], [sl])
                if len(offsets) > si and offsets[si]:
                    off = self.init_const(
                        "koff", np.asarray(offsets[si], np.int64)
                    )
                    sl2 = self.g.uname("keys_off")
                    self.g.add_node("Add", [sl, off], [sl2])
                    sl = sl2
                gath = self.g.uname("gather")
                self.g.add_node("Gather", [tname, sl], [gath], axis=0)
                pool = self.g.uname("pool")
                rax = self.init_const("rax", np.asarray([1], np.int64))
                self.g.add_node("ReduceSum", [gath, rax], [pool], keepdims=1)
                pooled_slots.append(pool)
                col += nnz
            top = se["sparse_embedding_name"]
            self.g.add_node("Concat", pooled_slots, [top], axis=1)
            self.shapes[top] = (self.batch, slots, ev)

    # ---------------------------------------------------------- dense layers
    def build_dense(self):
        outputs = []
        for li, cfg in enumerate(self.graph["dense_layers"]):
            t = cfg["layer_type"]
            bots: List[str] = cfg["bottom_names"]
            tops: List[str] = cfg["top_names"]
            fn = getattr(self, f"_op_{t}", None)
            if fn is None:
                raise NotImplementedError(f"ONNX export: layer {t}")
            out = fn(li, cfg, bots, tops)
            if out:
                outputs.extend(out)
        for o in outputs:
            self.g.add_output(o, [self.batch, 1])

    def _gemm(self, li, x, pname_w, pname_b, top, act=None, relu=False):
        w = self.w(li, pname_w)
        b = None
        try:
            b = self.w(li, pname_b)
        except KeyError:
            pass
        wn = self.init_const("W", w)
        pre = self.g.uname("gemm") if (act or relu) else top
        in_shape = self.shapes.get(x)
        if in_shape is not None and len(in_shape) == 3:
            # 3-D input (BST-style per-position projection): ONNX Gemm is
            # 2-D only, so emit MatMul (+ broadcast Add for bias) —
            # reference graph_builder.py does the same shape split
            mm = pre if b is None else self.g.uname("mm")
            self.g.add_node("MatMul", [x, wn], [mm])
            if b is not None:
                self.g.add_node("Add", [mm, self.init_const("B", b)], [pre])
            self.shapes[pre] = (in_shape[0], in_shape[1], w.shape[1])
            self.shapes[top] = self.shapes[pre]
        else:
            ins = [x, wn]
            if b is not None:
                ins.append(self.init_const("B", b))
            self.g.add_node("Gemm", ins, [pre])
            self.shapes[top] = (self.batch, w.shape[1])
        if relu or act == "relu":
            self.g.add_node("Relu", [pre], [top])
        elif act == "sigmoid":
            self.g.add_node("Sigmoid", [pre], [top])
        elif act == "tanh":
            self.g.add_node("Tanh", [pre], [top])
        elif act:
            self.g.add_node("Identity", [pre], [top])
        return w.shape[1]

    def _op_InnerProduct(self, li, cfg, bots, tops):
        act = cfg.get("act_type", "none")
        act = act if isinstance(act, str) else str(act)
        # hugectr InnerProduct has no fused act in reference; ours may
        self._gemm(li, bots[0], "weight", "bias", tops[0], act=None)
        return []

    def _op_FusedInnerProduct(self, li, cfg, bots, tops):
        self._gemm(li, bots[0], "weight", "bias", tops[0], relu=True)
        return []

    def _op_MLP(self, li, cfg, bots, tops):
        x = bots[0]
        n = len(cfg["num_outputs"])
        acts = cfg.get("activations") or [cfg.get("act_type", "relu")] * n
        for i in range(n):
            w = self.w(li, f"weight_{i}")
            bname = None
            try:
                bname = self.w(li, f"bias_{i}")
            except KeyError:
                pass
            ins = [x, self.init_const("W", w)]
            if bname is not None:
                ins.append(self.init_const("B", bname))
            y = tops[0] if (i == n - 1 and str(acts[i]) in ("none", "Activation_t.NonE")) else self.g.uname("mlp")
            self.g.add_node("Gemm", ins, [y])
            a = str(acts[i])
            if "relu" in a.lower():
                y2 = tops[0] if i == n - 1 else self.g.uname("mlp_act")
                self.g.add_node("Relu", [y], [y2])
                x = y2
            else:
                x = y
        if x != tops[0]:
            self.g.add_node("Identity", [x], [tops[0]])
        return []

    def _op_MultiCross(self, li, cfg, bots, tops):
        x0 = bots[0]
        n = cfg["num_layers"]
        proj = cfg.get("projection_dim", 0)
        x = x0
        for i in range(n):
            if proj:
                u = self.init_const("U", self.w(li, f"U_{i}"))
                v = self.init_const("V", self.w(li, f"V_{i}"))
                b = self.init_const("b", self.w(li, f"b_{i}"))
                h1 = self.g.uname("xcu")
                self.g.add_node("MatMul", [x, u], [h1])
                h2 = self.g.uname("xcv")
                self.g.add_node("MatMul", [h1, v], [h2])
                h3 = self.g.uname("xcb")
                self.g.add_node("Add", [h2, b], [h3])
                m = self.g.uname("xcm")
                self.g.add_node("Mul", [x0, h3], [m])
                nx = tops[0] if i == n - 1 else self.g.uname("xc")
                self.g.add_node("Add", [m, x], [nx])
                x = nx
            else:
                w = self.init_const("w", self.w(li, f"w_{i}").reshape(-1, 1))
                b = self.init_const("b", self.w(li, f"b_{i}"))
                xw = self.g.uname("xw")
                self.g.add_node("MatMul", [x, w], [xw])  # [B,1]
                m = self.g.uname("x0xw")
                self.g.add_node("Mul", [x0, xw], [m])
                a1 = self.g.uname("a1")
                self.g.add_node("Add", [m, b], [a1])
                nx = tops[0] if i == n - 1 else self.g.uname("xc")
                self.g.add_node("Add", [a1, x], [nx])
                x = nx
        return []

    def _op_Concat(self, li, cfg, bots, tops):
        axis = cfg.get("axis", 1)
        self.g.add_node("Concat", bots, [tops[0]], axis=axis)
        shp = [self.shapes.get(b) for b in bots]
        if all(s is not None for s in shp) and len({len(s) for s in shp}) == 1:
            out = list(shp[0])
            ax = axis if axis >= 0 else len(out) + axis
            out[ax] = sum(s[ax] for s in shp)
            self.shapes[tops[0]] = tuple(out)
        return []

    def _op_Reshape(self, li, cfg, bots, tops):
        if cfg.get("shape"):
            shp = np.asarray(cfg["shape"], np.int64)
        elif cfg.get("time_step"):
            shp = np.asarray(
                [-1, cfg["time_step"], cfg["leading_dim"]], np.int64
            )
        else:
            shp = np.asarray([-1, cfg["leading_dim"]], np.int64)
        s = self.init_const("shape", shp)
        self.g.add_node("Reshape", [bots[0], s], [tops[0]], allowzero=0)
        ins = self.shapes.get(bots[0])
        if ins is not None:
            n = int(np.prod(ins))
            dims = [int(d) for d in shp]
            fill = n // max(int(np.prod([d for d in dims if d > 0])), 1)
            self.shapes[tops[0]] = tuple(fill if d == -1 else d for d in dims)
        return []

    def _op_Slice(self, li, cfg, bots, tops):
        for (a, b_), top in zip(cfg["ranges"], tops):
            st = self.init_const("st", np.asarray([a], np.int64))
            en = self.init_const("en", np.asarray([b_], np.int64))
            ax = self.init_const("ax", np.asarray([-1], np.int64))
            self.g.add_node("Slice", [bots[0], st, en, ax], [top])
        return []

    def _op_ReLU(self, li, cfg, bots, tops):
        self.g.add_node("Relu", bots, tops)
        if bots[0] in self.shapes:
            self.shapes[tops[0]] = self.shapes[bots[0]]
        return []

    def _op_Sigmoid(self, li, cfg, bots, tops):
        self.g.add_node("Sigmoid", bots, tops)
        return []

    def _op_ELU(self, li, cfg, bots, tops):
        self.g.add_node("Elu", bots, tops, alpha=float(cfg.get("elu_alpha", 1.0)))
        return []

    def _op_Dropout(self, li, cfg, bots, tops):
        self.g.add_node("Identity", bots, tops)  # inference
        return []

    def _op_Add(self, li, cfg, bots, tops):
        x = bots[0]
        for i, b in enumerate(bots[1:]):
            y = tops[0] if i == len(bots) - 2 else self.g.uname("add")
            self.g.add_node("Add", [x, b], [y])
            x = y
        if bots[0] in self.shapes:
            self.shapes[tops[0]] = self.shapes[bots[0]]
        return []

    def _op_Sub(self, li, cfg, bots, tops):
        self.g.add_node("Sub", bots, tops)
        return []

    def _op_ElementwiseMultiply(self, li, cfg, bots, tops):
        self.g.add_node("Mul", bots, tops)
        return []

    def _op_ReduceSum(self, li, cfg, bots, tops):
        ax = self.init_const("axes", np.asarray([cfg.get("axis", 1)], np.int64))
        self.g.add_node("ReduceSum", [bots[0], ax], tops, keepdims=1)
        return []

    def _op_ReduceMean(self, li, cfg, bots, tops):
        self.g.add_node(
            "ReduceMean", bots, tops, axes=[cfg.get("axis", 1)], keepdims=1
        )
        return []

    def _op_WeightMultiply(self, li, cfg, bots, tops):
        # [B, n] * W[n, k] -> [B, n*k] (reference: weight_multiply_layer.cu)
        w = self.w(li, "weight")
        n, k = w.shape
        un = self.g.uname("unsq")
        ax = self.init_const("uax", np.asarray([2], np.int64))
        self.g.add_node("Unsqueeze", [bots[0], ax], [un])  # [B,n,1]
        wn = self.init_const("W", w[None, :, :])  # [1,n,k]
        m = self.g.uname("wm")
        self.g.add_node("Mul", [un, wn], [m])  # [B,n,k]
        shp = self.init_const("shape", np.asarray([-1, n * k], np.int64))
        self.g.add_node("Reshape", [m, shp], tops, allowzero=0)
        return []

    def _op_FmOrder2(self, li, cfg, bots, tops):
        # 0.5 * ((sum_i x_i)^2 - sum_i x_i^2) over slots of width out_dim
        k = cfg["out_dim"]
        shp = self.init_const("shape", np.asarray([0, -1, k], np.int64))
        x3 = self.g.uname("fm3d")
        self.g.add_node("Reshape", [bots[0], shp], [x3], allowzero=0)
        ax = self.init_const("axes", np.asarray([1], np.int64))
        s = self.g.uname("fmsum")
        self.g.add_node("ReduceSum", [x3, ax], [s], keepdims=0)
        s2 = self.g.uname("fmsum2")
        self.g.add_node("Mul", [s, s], [s2])
        xx = self.g.uname("fmxx")
        self.g.add_node("Mul", [x3, x3], [xx])
        sx2 = self.g.uname("fmsx2")
        ax2 = self.init_const("axes", np.asarray([1], np.int64))
        self.g.add_node("ReduceSum", [xx, ax2], [sx2], keepdims=0)
        d = self.g.uname("fmd")
        self.g.add_node("Sub", [s2, sx2], [d])
        half = self.init_const("half", np.asarray(0.5, np.float32))
        self.g.add_node("Mul", [d, half], tops)
        return []

    def _op_Interaction(self, li, cfg, bots, tops):
        # DLRM pairwise-dot: bots = [mlp [B,E], emb3d [B,S,E]]
        mlp, emb = bots[0], bots[1]
        axu = self.init_const("axu", np.asarray([1], np.int64))
        m3 = self.g.uname("m3")
        self.g.add_node("Unsqueeze", [mlp, axu], [m3])  # [B,1,E]
        cat = self.g.uname("icat")
        self.g.add_node("Concat", [m3, emb], [cat], axis=1)  # [B,S+1,E]
        tr = self.g.uname("itr")
        self.g.add_node("Transpose", [cat, ], [tr], perm=[0, 2, 1])
        dots = self.g.uname("idots")
        self.g.add_node("MatMul", [cat, tr], [dots])  # [B,S+1,S+1]
        flat = self.g.uname("iflat")
        # lower-triangle (i<j) indices gathered from the flattened matrix
        # need S; derive from shapes dict
        s_plus1 = None
        for name, shp in self.shapes.items():
            if name == emb.split(":")[0] and len(shp) == 3:
                s_plus1 = shp[1] + 1
        if s_plus1 is None:
            raise NotImplementedError("Interaction: unknown emb shape")
        idx = np.asarray(
            [i * s_plus1 + j for i in range(s_plus1) for j in range(i + 1, s_plus1)],
            np.int64,
        )
        shp = self.init_const("shape", np.asarray([0, s_plus1 * s_plus1], np.int64))
        self.g.add_node("Reshape", [dots, shp], [flat], allowzero=0)
        gi = self.init_const("triu", idx)
        gathered = self.g.uname("igath")
        self.g.add_node("Gather", [flat, gi], [gathered], axis=1)
        self.g.add_node("Concat", [mlp, gathered], [tops[0]], axis=1)
        return []

    def _op_Softmax(self, li, cfg, bots, tops):
        self.g.add_node("Softmax", bots[:1], tops, axis=-1)
        return []

    def _op_MatrixMultiply(self, li, cfg, bots, tops):
        """Plain MatMul (reference converter: graph_builder.py:1158); the
        layer's transpose_b (3-D attention products, gemm.py::_mm_apply)
        becomes an explicit Transpose, and the 2-D x 3-D contraction
        bm,mgh->bgh lowers to Reshape+MatMul+Reshape."""
        a, b = bots
        sa, sb = self.shapes.get(a), self.shapes.get(b)
        if cfg.get("transpose_b"):
            # transpose_b only applies to 3-D operands (gemm.py::_mm_apply)
            bt = self.g.uname("mmT")
            self.g.add_node("Transpose", [b], [bt], perm=[0, 2, 1])
            if sb is not None and len(sb) == 3:
                self.shapes[bt] = (sb[0], sb[2], sb[1])
            b = bt
            sb = self.shapes.get(bt)
        if sa is not None and sb is not None and len(sa) == 2 and len(sb) == 3:
            # bm,mgh->bgh: flatten b to [M, G*H], matmul, reshape back
            m, gdim, h = sb
            bf = self.g.uname("mmf")
            shp = self.init_const("mmshape", np.asarray([m, gdim * h], np.int64))
            self.g.add_node("Reshape", [b, shp], [bf], allowzero=0)
            mm = self.g.uname("mm")
            self.g.add_node("MatMul", [a, bf], [mm])
            shp2 = self.init_const(
                "mmshape2", np.asarray([sa[0], gdim, h], np.int64)
            )
            self.g.add_node("Reshape", [mm, shp2], tops, allowzero=0)
            self.shapes[tops[0]] = (sa[0], gdim, h)
            return []
        self.g.add_node("MatMul", [a, b], tops)
        if sa is not None and sb is not None:
            if len(sa) == 2 and len(sb) == 2:
                self.shapes[tops[0]] = (sa[0], sb[1])
            elif len(sa) == 3 and len(sb) == 3:
                self.shapes[tops[0]] = (sa[0], sa[1], sb[2])
        return []

    def _op_MaskedSoftmax(self, li, cfg, bots, tops):
        """x*scale, mask==0 positions forced to -10000, softmax on the last
        axis (reference: src/layers/masked_softmax_layer.cu)."""
        x, mask = bots
        scale = float(cfg.get("factor", 1.0) or 1.0)
        xs = self.g.uname("msc")
        self.g.add_node(
            "Mul",
            [x, self.init_const("scale", np.asarray([scale], np.float32))],
            [xs],
        )
        gt = self.g.uname("msb")
        self.g.add_node(
            "Greater",
            [mask, self.init_const("zero", np.asarray([0.0], np.float32))],
            [gt],
        )
        w_ = self.g.uname("msw")
        neg = self.init_const("neg", np.asarray([-10000.0], np.float32))
        self.g.add_node("Where", [gt, xs, neg], [w_])
        self.g.add_node("Softmax", [w_], tops, axis=-1)
        if x in self.shapes:
            self.shapes[tops[0]] = self.shapes[x]
        return []

    def _op_Select(self, li, cfg, bots, tops):
        """Static index selection along `dim` (layers/core_layers.py::Select)
        -> ONNX Gather with constant indices."""
        dim = int(cfg.get("dim", 1))
        idx = self.init_const("sel_idx", np.asarray(cfg["index"], np.int64))
        self.g.add_node("Gather", [bots[0], idx], tops, axis=dim)
        s = self.shapes.get(bots[0])
        if s is not None:
            s2 = list(s)
            s2[dim] = len(cfg["index"])
            self.shapes[tops[0]] = tuple(s2)
        return []

    def _op_Gather(self, li, cfg, bots, tops):
        """Static batch-row gather (layers/core_layers.py::Gather, axis 0)."""
        idx = self.init_const("gat_idx", np.asarray(cfg["indices"], np.int64))
        self.g.add_node("Gather", [bots[0], idx], tops, axis=0)
        s = self.shapes.get(bots[0])
        if s is not None:
            self.shapes[tops[0]] = (len(cfg["indices"]),) + tuple(s[1:])
        return []

    def _op_Scale(self, li, cfg, bots, tops):
        f = int(cfg.get("factor", 1))
        if cfg.get("axis", 0) == 0:
            # repeat each element f times along features
            axu = self.init_const("axu", np.asarray([2], np.int64))
            un = self.g.uname("scu")
            self.g.add_node("Unsqueeze", [bots[0], axu], [un])
            ones = self.init_const("ones", np.ones((1, 1, f), np.float32))
            m = self.g.uname("scm")
            self.g.add_node("Mul", [un, ones], [m])
            shp = self.init_const("shape", np.asarray([0, -1], np.int64))
            self.g.add_node("Reshape", [m, shp], tops, allowzero=0)
        else:
            tile = self.init_const("reps", np.asarray([f, 1], np.int64))
            self.g.add_node("Tile", [bots[0], tile], tops)
        return []

    def _op_BatchNorm(self, li, cfg, bots, tops):
        g_ = self.init_const("gamma", self.w(li, "gamma"))
        b_ = self.init_const("beta", self.w(li, "beta"))
        # running stats live in net_state
        mean = var = None
        for k, v in self.dense.items():
            if k.startswith("net_state/") and f"l{li}_" in k:
                if k.endswith("mean"):
                    mean = v
                if k.endswith("var"):
                    var = v
        m = self.init_const("mean", mean if mean is not None else np.zeros_like(self.w(li, "gamma")))
        v_ = self.init_const("var", var if var is not None else np.ones_like(self.w(li, "gamma")))
        self.g.add_node(
            "BatchNormalization",
            [bots[0], g_, b_, m, v_],
            tops,
            epsilon=float(cfg.get("eps", 1e-5)),
        )
        return []


    def _op_PReLU_Dice(self, li, cfg, bots, tops):
        # Dice(x) = p*x + (1-p)*alpha*x. At inference there is no batch to
        # standardize over, so p = sigmoid(x) (identity standardization) —
        # same inference-time approximation the reference converter makes
        # (onnx_converter graph_builder PReLU_Dice branch).
        a = float(cfg.get("elu_alpha", 0.2))
        sig = self.g.uname("dice_sig")
        self.g.add_node("Sigmoid", [bots[0]], [sig])
        px = self.g.uname("dice_px")
        self.g.add_node("Mul", [sig, bots[0]], [px])
        one = self.init_const("one", np.asarray(1.0, np.float32))
        inv = self.g.uname("dice_inv")
        self.g.add_node("Sub", [one, sig], [inv])
        ax_ = self.g.uname("dice_ax")
        alpha_c = self.init_const("alpha", np.asarray(a, np.float32))
        self.g.add_node("Mul", [inv, alpha_c], [ax_])
        axx = self.g.uname("dice_axx")
        self.g.add_node("Mul", [ax_, bots[0]], [axx])
        self.g.add_node("Add", [px, axx], tops)
        return []

    def _op_SequenceMask(self, li, cfg, bots, tops):
        # [B,1] lengths -> [B,1,F,T] boolean-ish mask (float 0/1)
        F = int(cfg["max_sequence_len_from"])
        T = int(cfg["max_sequence_len_to"])
        i_idx = self.init_const("i", np.arange(F, dtype=np.float32).reshape(1, 1, F, 1))
        j_idx = self.init_const("j", np.arange(T, dtype=np.float32).reshape(1, 1, 1, T))
        lf = self.g.uname("lf")
        axs = self.init_const("sq_ax", np.asarray([1, 2], np.int64))
        self.g.add_node("Unsqueeze", [bots[0], axs], [lf])  # [B,1,1,1]
        lt = self.g.uname("lt")
        self.g.add_node("Unsqueeze", [bots[1], axs], [lt])
        m1 = self.g.uname("m1")
        self.g.add_node("Less", [i_idx, lf], [m1])
        m2 = self.g.uname("m2")
        self.g.add_node("Less", [j_idx, lt], [m2])
        mb = self.g.uname("mb")
        self.g.add_node("And", [m1, m2], [mb])
        self.g.add_node("Cast", [mb], tops, to=1)  # FLOAT
        return []

    def _op_MultiHeadAttention(self, li, cfg, bots, tops):
        # q,k,v [B,S,D] (+ optional mask [B,1,S,S]); heads h
        h = int(cfg.get("num_attention_heads", 1))
        q, k, v = bots[0], bots[1], bots[2]
        # infer S, D from shapes dict if known; require static
        shp = None
        for name in (q, k, v):
            if name in self.shapes and len(self.shapes[name]) == 3:
                shp = self.shapes[name]
        if shp is None:
            raise NotImplementedError("MHA export needs known 3D input shape")
        _, S, D = shp
        dk = D // h

        def split_heads(x):
            r = self.g.uname("mha_r")
            sc = self.init_const("shape", np.asarray([0, S, h, dk], np.int64))
            self.g.add_node("Reshape", [x, sc], [r], allowzero=0)
            t = self.g.uname("mha_t")
            self.g.add_node("Transpose", [r], [t], perm=[0, 2, 1, 3])
            return t  # [B,h,S,dk]

        qh, kh, vh = split_heads(q), split_heads(k), split_heads(v)
        kt = self.g.uname("mha_kt")
        self.g.add_node("Transpose", [kh], [kt], perm=[0, 1, 3, 2])
        scores = self.g.uname("mha_scores")
        self.g.add_node("MatMul", [qh, kt], [scores])
        scale = self.init_const("scale", np.asarray(1.0 / np.sqrt(dk), np.float32))
        ss = self.g.uname("mha_ss")
        self.g.add_node("Mul", [scores, scale], [ss])
        if len(bots) > 3:
            # masked positions -> -1e4 (reference masked softmax)
            one = self.init_const("one", np.asarray(1.0, np.float32))
            neg = self.init_const("neg", np.asarray(-10000.0, np.float32))
            inv = self.g.uname("mha_inv")
            self.g.add_node("Sub", [one, bots[3]], [inv])
            pen = self.g.uname("mha_pen")
            self.g.add_node("Mul", [inv, neg], [pen])
            masked = self.g.uname("mha_masked")
            sm_in = masked
            self.g.add_node("Add", [ss, pen], [masked])
        else:
            sm_in = ss
        probs = self.g.uname("mha_probs")
        self.g.add_node("Softmax", [sm_in], [probs], axis=-1)
        ctxv = self.g.uname("mha_ctx")
        self.g.add_node("MatMul", [probs, vh], [ctxv])  # [B,h,S,dk]
        tb = self.g.uname("mha_tb")
        self.g.add_node("Transpose", [ctxv], [tb], perm=[0, 2, 1, 3])
        so = self.init_const("shape", np.asarray([0, S, D], np.int64))
        self.g.add_node("Reshape", [tb, so], tops, allowzero=0)
        self.shapes[tops[0]] = (self.batch, S, D)
        return []

    def _op_FusedReshapeConcat(self, li, cfg, bots, tops):
        # inputs [B,F+1,Ei] -> his [B*F, sumE], item [B, sumE]
        cat = self.g.uname("frc_cat")
        self.g.add_node("Concat", bots, [cat], axis=2)
        # need F+1 and sumE from shapes
        shp = self.shapes.get(bots[0])
        if shp is None or len(shp) != 3:
            raise NotImplementedError("FusedReshapeConcat export needs shapes")
        fp1 = shp[1]
        sume = sum(self.shapes[b][2] for b in bots)
        st = self.init_const("st", np.asarray([0], np.int64))
        en = self.init_const("en", np.asarray([fp1 - 1], np.int64))
        ax = self.init_const("ax", np.asarray([1], np.int64))
        his3 = self.g.uname("frc_his3")
        self.g.add_node("Slice", [cat, st, en, ax], [his3])
        sh = self.init_const("shape", np.asarray([-1, sume], np.int64))
        self.g.add_node("Reshape", [his3, sh], [tops[0]], allowzero=0)
        st2 = self.init_const("st2", np.asarray([fp1 - 1], np.int64))
        en2 = self.init_const("en2", np.asarray([fp1], np.int64))
        item3 = self.g.uname("frc_item3")
        self.g.add_node("Slice", [cat, st2, en2, ax], [item3])
        sh2 = self.init_const("shape", np.asarray([-1, sume], np.int64))
        self.g.add_node("Reshape", [item3, sh2], [tops[1]], allowzero=0)
        self.shapes[tops[1]] = (self.batch, sume)
        return []

    def _op_LayerNorm(self, li, cfg, bots, tops):
        g_ = self.init_const("gamma", self.w(li, "gamma"))
        b_ = self.init_const("beta", self.w(li, "beta"))
        self.g.add_node(
            "LayerNormalization",
            [bots[0], g_, b_],
            tops,
            epsilon=float(cfg.get("eps", 1e-5)),
            axis=-1,
        )
        if bots[0] in self.shapes:
            self.shapes[tops[0]] = self.shapes[bots[0]]
        return []

    def _op_GRU(self, li, cfg, bots, tops):
        """GRU export (reference: graph_builder.py GRU path). Our layer
        stores w [V, 3H] / u [H, 3H] with gates stacked (z, r, n) — matching
        ONNX's (z, r, h) order with linear_before_reset=1 (the layer applies
        the reset gate AFTER the hidden projection, gru_layer semantics)."""
        S, V, H = cfg["SeqLength"], cfg["vector_size"], cfg["num_output"]
        w = self.w(li, "w")      # [V, 3H]
        u = self.w(li, "u")      # [H, 3H]
        bw = self.w(li, "bw")    # [3H]
        bu = self.w(li, "bu")    # [3H]
        W = self.init_const("gru_W", w.T[None])          # [1, 3H, V]
        R = self.init_const("gru_R", u.T[None])          # [1, 3H, H]
        B = self.init_const(
            "gru_B", np.concatenate([bw, bu])[None]       # [1, 6H]
        )
        shp = self.init_const("gru_in", np.asarray([-1, S, V], np.int64))
        x3 = self.g.uname("gru_x3")
        self.g.add_node("Reshape", [bots[0], shp], [x3], allowzero=0)
        xt = self.g.uname("gru_xt")
        self.g.add_node("Transpose", [x3], [xt], perm=[1, 0, 2])
        y = self.g.uname("gru_y")
        yh = self.g.uname("gru_yh")
        self.g.add_node(
            "GRU",
            [xt, W, R, B],
            [y, yh],
            hidden_size=int(H),
            linear_before_reset=1,
        )
        # Y: [S, 1, B, H] -> [B, S*H]
        yt = self.g.uname("gru_yt")
        self.g.add_node("Transpose", [y], [yt], perm=[2, 0, 1, 3])
        out_shp = self.init_const("gru_out", np.asarray([-1, S * H], np.int64))
        self.g.add_node("Reshape", [yt, out_shp], [tops[0]], allowzero=0)
        self.shapes[tops[0]] = (self.batch, S * H)
        return []

    def _op_BinaryCrossEntropyLoss(self, li, cfg, bots, tops):
        # inference output = sigmoid(logits) (reference converter behavior)
        out = f"{tops[0]}_pred"
        self.g.add_node("Sigmoid", [bots[0]], [out])
        return [out]

    def _op_CrossEntropyLoss(self, li, cfg, bots, tops):
        out = f"{tops[0]}_pred"
        self.g.add_node("Softmax", [bots[0]], [out], axis=-1)
        return [out]

    def _op_MultiCrossEntropyLoss(self, li, cfg, bots, tops):
        out = f"{tops[0]}_pred"
        self.g.add_node("Sigmoid", [bots[0]], [out])
        return [out]

    def run(self, out_path: str):
        self.build_embeddings()
        self.build_dense()
        self.g.save(out_path)


def convert(
    onnx_model_path: str,
    graph_config: str,
    dense_model: str,
    convert_embedding: bool = False,
    sparse_models=None,
    ntp_file: Optional[str] = None,
    graph_name: str = "hugectr",
    batch_size: Optional[int] = None,
) -> None:
    """Reference-parity entry point (hugectr2onnx.converter.convert,
    onnx_converter/hugectr2onnx/converter.py — same positional/keyword
    spelling). `dense_model` may be a snapshot DIRECTORY (this framework's
    layout: dense_model.npz + sparse_<name>/ side by side) or the
    dense_model.npz file itself; explicit `sparse_models` dirs (each named
    `sparse_<table>` or `<table>`) override the snapshot-dir tables, and the
    explicit dense_model is always the one exported. `ntp_file` is accepted
    for signature compatibility — non-trainable state lives inside
    dense_model.npz here. `convert_embedding=False` (the reference default)
    exports the dense graph with the embedding outputs as model inputs;
    pass True to inline the tables as ONNX Gather initializers."""
    if dense_model.endswith(".npz"):
        dense_npz = dense_model
        snapshot_dir = os.path.dirname(dense_model) or "."
    else:
        dense_npz = os.path.join(dense_model, "dense_model.npz")
        snapshot_dir = dense_model
    sparse_dirs: Dict[str, str] = {}
    for p in sparse_models or []:
        base = os.path.basename(p.rstrip("/"))
        name = base[len("sparse_"):] if base.startswith("sparse_") else base
        sparse_dirs[name] = p
    with open(graph_config) as f:
        graph = json.load(f)
    _Converter(
        graph,
        snapshot_dir,
        batch_size,
        dense_npz=dense_npz,
        sparse_dirs=sparse_dirs,
        convert_embedding=convert_embedding,
    ).run(onnx_model_path)


def main(argv=None) -> None:
    """`python -m hugectr_tpu_torch.tools.hugectr2onnx`, the flags of the
    root `hugectr2onnx/converter.py` command (numpy only: no device)."""
    import argparse

    p = argparse.ArgumentParser(description="Convert model to ONNX")
    p.add_argument("--onnx_model_path", required=True)
    p.add_argument("--graph_config", required=True)
    p.add_argument("--dense_model", required=True)
    p.add_argument("--convert_embedding", action="store_true")
    p.add_argument("--sparse_models", nargs="*", default=None)
    p.add_argument("--ntp_file", default=None)
    p.add_argument("--graph_name", default="hugectr")
    p.add_argument("--batch_size", type=int, default=None)
    a = p.parse_args(argv)
    convert(a.onnx_model_path, a.graph_config, a.dense_model, convert_embedding=a.convert_embedding,
            sparse_models=a.sparse_models, ntp_file=a.ntp_file, graph_name=a.graph_name, batch_size=a.batch_size)


if __name__ == "__main__":
    main()
