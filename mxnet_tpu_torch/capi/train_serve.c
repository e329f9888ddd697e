/* Train a network and serve it through the flat C ABI only (no Python in
 * this translation unit): the port's C-API smoke client.
 *
 *   train_serve <symbol.json> <init.params> <batches.bin> <rows.bin> <out_dir>
 *               <dev_type> <batch> <steps> <rows> <C> <H> <W> <lr>
 *
 * It binds the symbol through MXExecutorBind on device <dev_type> (2: the
 * card, 1: the CPU) with the parameters of <init.params> (an MXNDArraySave
 * file, names as the symbol lists them), runs <steps> training steps on the
 * batches of <batches.bin> (float32: steps x batch x C x H x W images, then
 * steps x batch labels): MXExecutorForward(is_train=1), MXExecutorBackward,
 * and sgd_mom_update through MXImperativeInvoke (momentum 0.9, wd 1e-4,
 * rescale 1/batch), each step ended by MXNDArrayWaitAll and timed. It saves
 * the trained parameters to <out_dir>/trained.params ("arg:"/"aux:" names),
 * pushes one axpy through MXRtcCreate/MXRtcPush and checks it, then serves
 * the trained parameters through MXPredCreate at <rows> rows of <rows.bin>
 * and writes the outputs to <out_dir>/pred.bin. It prints one line
 * "CAPI_CLIENT {json}" and exits 0, or names the failing call and exits 1.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include <mxnet_tpu/c_api.h>

#define CHECK(call)                                                    \
  do {                                                                 \
    if ((call) != 0) {                                                 \
      fprintf(stderr, "FAIL %s:%d %s: %s\n", __FILE__, __LINE__, #call, \
              MXGetLastError());                                       \
      exit(1);                                                         \
    }                                                                  \
  } while (0)

#define MAX_STEPS 64

static double now_ms(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec * 1e3 + ts.tv_nsec / 1e6;
}

static char *read_file(const char *path, size_t *size) {
  FILE *f = fopen(path, "rb");
  char *buf;
  if (!f) {
    fprintf(stderr, "FAIL cannot open %s\n", path);
    exit(1);
  }
  fseek(f, 0, SEEK_END);
  *size = (size_t)ftell(f);
  fseek(f, 0, SEEK_SET);
  buf = (char *)malloc(*size + 1);
  if (fread(buf, 1, *size, f) != *size) {
    fprintf(stderr, "FAIL short read of %s\n", path);
    exit(1);
  }
  buf[*size] = 0;
  fclose(f);
  return buf;
}

static char **copy_names(mx_uint n, const char **names) {
  char **out = (char **)malloc(sizeof(char *) * (n ? n : 1));
  mx_uint i;
  for (i = 0; i < n; ++i) out[i] = strdup(names[i]);
  return out;
}

static size_t numel(mx_uint ndim, const mx_uint *shape) {
  size_t n = 1;
  mx_uint i;
  for (i = 0; i < ndim; ++i) n *= shape[i];
  return n;
}

/* a device array of the given shape holding the loaded array of that name,
 * or zeros where none is loaded */
static NDArrayHandle device_array(const char *name, mx_uint ndim,
                                  const mx_uint *shape, int dev_type,
                                  mx_uint n_loaded, NDArrayHandle *loaded,
                                  const char **loaded_names) {
  NDArrayHandle arr;
  mx_uint i;
  size_t n = numel(ndim, shape);
  CHECK(MXNDArrayCreate(shape, ndim, dev_type, 0, 0, &arr));
  for (i = 0; i < n_loaded; ++i) {
    if (strcmp(loaded_names[i], name) == 0) {
      float *host = (float *)malloc(sizeof(float) * n);
      CHECK(MXNDArraySyncCopyToCPU(loaded[i], host, n));
      CHECK(MXNDArraySyncCopyFromCPU(arr, host, n));
      free(host);
      break;
    }
  }
  return arr;
}

int main(int argc, char **argv) {
  const char *json_path, *params_path, *batches_path, *rows_path, *out_dir;
  int dev_type, batch, steps, rows, C, H, W;
  float lr;
  SymbolHandle net;
  NDArrayHandle *loaded;
  const char **loaded_names_c;
  char **loaded_names;
  mx_uint n_loaded, n_loaded_names;
  mx_uint n_args, n_aux, i;
  const char **names_c;
  char **arg_names, **aux_names;
  mx_uint in_size, out_size, aux_size;
  const mx_uint *in_ndim, *out_ndim, *aux_ndim;
  const mx_uint **in_data, **out_data, **aux_data;
  int complete;
  NDArrayHandle *args, *grads, *moms, *auxs;
  mx_uint *reqs;
  ExecutorHandle exec;
  AtomicSymbolCreator sgd;
  size_t img_elems, bytes;
  float *batches;
  double step_ms[MAX_STEPS];
  int data_idx = -1, label_idx = -1, s;
  char path[4096], rs[32], wds[32], mom[32], lrs[32];
  char line[8192];
  size_t pos;

  if (argc != 14) {
    fprintf(stderr, "usage: %s symbol.json init.params batches.bin rows.bin "
            "out_dir dev_type batch steps rows C H W lr\n", argv[0]);
    return 2;
  }
  json_path = argv[1];
  params_path = argv[2];
  batches_path = argv[3];
  rows_path = argv[4];
  out_dir = argv[5];
  dev_type = atoi(argv[6]);
  batch = atoi(argv[7]);
  steps = atoi(argv[8]);
  rows = atoi(argv[9]);
  C = atoi(argv[10]);
  H = atoi(argv[11]);
  W = atoi(argv[12]);
  lr = (float)atof(argv[13]);
  if (steps > MAX_STEPS) steps = MAX_STEPS;
  img_elems = (size_t)C * H * W;

  /* ---------------------------------------------------------- bind */
  CHECK(MXSymbolCreateFromFile(json_path, &net));
  CHECK(MXNDArrayLoad(params_path, &n_loaded, &loaded, &n_loaded_names,
                      &loaded_names_c));
  loaded_names = copy_names(n_loaded_names, loaded_names_c);
  CHECK(MXSymbolListArguments(net, &n_args, &names_c));
  arg_names = copy_names(n_args, names_c);
  CHECK(MXSymbolListAuxiliaryStates(net, &n_aux, &names_c));
  aux_names = copy_names(n_aux, names_c);
  {
    const char *keys[2] = {"data", "softmax_label"};
    mx_uint indptr[3] = {0, 4, 5};
    mx_uint shape[5];
    shape[0] = (mx_uint)batch;
    shape[1] = (mx_uint)C;
    shape[2] = (mx_uint)H;
    shape[3] = (mx_uint)W;
    shape[4] = (mx_uint)batch;
    CHECK(MXSymbolInferShape(net, 2, keys, indptr, shape, &in_size,
                             &in_ndim, &in_data, &out_size, &out_ndim,
                             &out_data, &aux_size, &aux_ndim, &aux_data,
                             &complete));
  }
  if (!complete || in_size != n_args || aux_size != n_aux) {
    fprintf(stderr, "FAIL shape inference incomplete\n");
    return 1;
  }
  args = (NDArrayHandle *)calloc(n_args, sizeof(NDArrayHandle));
  grads = (NDArrayHandle *)calloc(n_args, sizeof(NDArrayHandle));
  moms = (NDArrayHandle *)calloc(n_args, sizeof(NDArrayHandle));
  reqs = (mx_uint *)calloc(n_args, sizeof(mx_uint));
  auxs = (NDArrayHandle *)calloc(n_aux ? n_aux : 1, sizeof(NDArrayHandle));
  /* shapes live in the thread's store until the next call: use them now */
  for (i = 0; i < n_args; ++i) {
    int is_input = strcmp(arg_names[i], "data") == 0 ||
                   strcmp(arg_names[i], "softmax_label") == 0;
    if (strcmp(arg_names[i], "data") == 0) data_idx = (int)i;
    if (strcmp(arg_names[i], "softmax_label") == 0) label_idx = (int)i;
    args[i] = device_array(arg_names[i], in_ndim[i], in_data[i], dev_type,
                           n_loaded, loaded,
                           (const char **)loaded_names);
    if (!is_input) {
      CHECK(MXNDArrayCreate(in_data[i], in_ndim[i], dev_type, 0, 0,
                            &grads[i]));
      CHECK(MXNDArrayCreate(in_data[i], in_ndim[i], dev_type, 0, 0,
                            &moms[i]));
      reqs[i] = 1;
    }
  }
  for (i = 0; i < n_aux; ++i)
    auxs[i] = device_array(aux_names[i], aux_ndim[i], aux_data[i],
                           dev_type, n_loaded, loaded,
                           (const char **)loaded_names);
  if (data_idx < 0 || label_idx < 0) {
    fprintf(stderr, "FAIL the symbol has no data/softmax_label input\n");
    return 1;
  }
  CHECK(MXExecutorBind(net, dev_type, 0, n_args, args, grads, reqs, n_aux,
                       auxs, &exec));
  CHECK(MXNDArrayWaitAll());

  /* ------------------------------------------------------------ train */
  batches = (float *)read_file(batches_path, &bytes);
  if (bytes != sizeof(float) * (size_t)steps * batch * (img_elems + 1)) {
    fprintf(stderr, "FAIL %s holds %zu bytes\n", batches_path, bytes);
    return 1;
  }
  CHECK(MXGetFunction("sgd_mom_update", (FunctionHandle *)&sgd));
  snprintf(lrs, sizeof(lrs), "%.9g", lr);
  snprintf(mom, sizeof(mom), "%.9g", 0.9);
  snprintf(wds, sizeof(wds), "%.9g", 1e-4);
  snprintf(rs, sizeof(rs), "%.9g", 1.0 / batch);
  for (s = 0; s < steps; ++s) {
    const float *x = batches + (size_t)s * batch * img_elems;
    const float *y = batches + (size_t)steps * batch * img_elems +
                     (size_t)s * batch;
    double t0 = now_ms();
    const char *keys[4] = {"lr", "momentum", "wd", "rescale_grad"};
    const char *vals[4];
    vals[0] = lrs;
    vals[1] = mom;
    vals[2] = wds;
    vals[3] = rs;
    CHECK(MXNDArraySyncCopyFromCPU(args[data_idx], x,
                                   (size_t)batch * img_elems));
    CHECK(MXNDArraySyncCopyFromCPU(args[label_idx], y, (size_t)batch));
    CHECK(MXExecutorForward(exec, 1));
    CHECK(MXExecutorBackward(exec, 0, NULL));
    for (i = 0; i < n_args; ++i) {
      NDArrayHandle ins[3], outs_buf[2];
      NDArrayHandle *outs = outs_buf;
      int n_out = 2;
      if (!reqs[i]) continue;
      ins[0] = args[i];
      ins[1] = grads[i];
      ins[2] = moms[i];
      outs_buf[0] = args[i];
      outs_buf[1] = moms[i];
      CHECK(MXImperativeInvoke(sgd, 3, ins, &n_out, &outs, 4, keys, vals));
    }
    CHECK(MXNDArrayWaitAll());
    step_ms[s] = now_ms() - t0;
  }
  free(batches);
  {
    NDArrayHandle *save = (NDArrayHandle *)malloc(
        sizeof(NDArrayHandle) * (n_args + n_aux));
    char **keys = (char **)malloc(sizeof(char *) * (n_args + n_aux));
    mx_uint n = 0;
    for (i = 0; i < n_args; ++i) {
      if (!reqs[i]) continue;
      keys[n] = (char *)malloc(strlen(arg_names[i]) + 5);
      sprintf(keys[n], "arg:%s", arg_names[i]);
      save[n++] = args[i];
    }
    for (i = 0; i < n_aux; ++i) {
      keys[n] = (char *)malloc(strlen(aux_names[i]) + 5);
      sprintf(keys[n], "aux:%s", aux_names[i]);
      save[n++] = auxs[i];
    }
    snprintf(path, sizeof(path), "%s/trained.params", out_dir);
    CHECK(MXNDArraySave(path, n, save, (const char **)keys));
  }

  /* -------------------------------------------------------------- rtc */
  {
    const mx_uint n = 1u << 20;
    mx_uint shape[1];
    float *xv = (float *)malloc(sizeof(float) * n);
    float *yv = (float *)malloc(sizeof(float) * n);
    float *zv = (float *)malloc(sizeof(float) * n);
    NDArrayHandle ins[2], outs[1];
    char *in_names[2] = {(char *)"x", (char *)"y"};
    char *out_names[1] = {(char *)"z"};
    RtcHandle rtc;
    mx_uint k, bad = 0;
    shape[0] = n;
    for (k = 0; k < n; ++k) {
      xv[k] = (float)(k % 1000) * 0.001f - 0.5f;
      yv[k] = (float)(k % 777) * 0.01f;
    }
    CHECK(MXNDArrayCreate(shape, 1, dev_type, 0, 0, &ins[0]));
    CHECK(MXNDArrayCreate(shape, 1, dev_type, 0, 0, &ins[1]));
    CHECK(MXNDArrayCreate(shape, 1, dev_type, 0, 0, &outs[0]));
    CHECK(MXNDArraySyncCopyFromCPU(ins[0], xv, n));
    CHECK(MXNDArraySyncCopyFromCPU(ins[1], yv, n));
    CHECK(MXRtcCreate((char *)"axpy", 2, 1, in_names, out_names, ins, outs,
                      (char *)"z_ref[...] = x_ref[...] * 2.0 + y_ref[...]",
                      &rtc));
    CHECK(MXRtcPush(rtc, 2, 1, ins, outs, 1, 1, 1, 1, 1, 1));
    CHECK(MXNDArrayWaitAll());
    CHECK(MXNDArraySyncCopyToCPU(outs[0], zv, n));
    for (k = 0; k < n; ++k)
      if (zv[k] != xv[k] * 2.0f + yv[k]) ++bad;
    if (bad) {
      fprintf(stderr, "FAIL rtc axpy: %u of %u elements differ\n", bad, n);
      return 1;
    }
    CHECK(MXRtcFree(rtc));
    CHECK(MXNDArrayFree(ins[0]));
    CHECK(MXNDArrayFree(ins[1]));
    CHECK(MXNDArrayFree(outs[0]));
    free(xv);
    free(yv);
    free(zv);
  }

  /* ------------------------------------------------------------ serve */
  {
    size_t json_size, param_size, rows_bytes;
    char *json = read_file(json_path, &json_size);
    char *blob;
    float *xr = (float *)read_file(rows_path, &rows_bytes);
    PredictorHandle pred;
    const char *keys[1] = {"data"};
    mx_uint indptr[2] = {0, 4};
    mx_uint shape[4];
    mx_uint *oshape, ondim;
    size_t out_elems;
    float *out;
    FILE *f;
    double t0;
    snprintf(path, sizeof(path), "%s/trained.params", out_dir);
    blob = read_file(path, &param_size);
    shape[0] = (mx_uint)rows;
    shape[1] = (mx_uint)C;
    shape[2] = (mx_uint)H;
    shape[3] = (mx_uint)W;
    if (rows_bytes != sizeof(float) * (size_t)rows * img_elems) {
      fprintf(stderr, "FAIL %s holds %zu bytes\n", rows_path, rows_bytes);
      return 1;
    }
    CHECK(MXPredCreate(json, blob, (int)param_size, dev_type, 0, 1, keys,
                       indptr, shape, &pred));
    CHECK(MXPredSetInput(pred, "data", xr, (mx_uint)(rows * img_elems)));
    t0 = now_ms();
    CHECK(MXPredForward(pred));
    CHECK(MXPredGetOutputShape(pred, 0, &oshape, &ondim));
    out_elems = numel(ondim, oshape);
    out = (float *)malloc(sizeof(float) * out_elems);
    CHECK(MXPredGetOutput(pred, 0, out, (mx_uint)out_elems));
    pos = (size_t)snprintf(line, sizeof(line),
                           "CAPI_CLIENT {\"pred_ms\": %.3f, "
                           "\"pred_shape\": [%u, %u], \"step_ms\": [",
                           now_ms() - t0, oshape[0],
                           ondim > 1 ? oshape[1] : 1);
    snprintf(path, sizeof(path), "%s/pred.bin", out_dir);
    f = fopen(path, "wb");
    if (!f || fwrite(out, sizeof(float), out_elems, f) != out_elems) {
      fprintf(stderr, "FAIL cannot write %s\n", path);
      return 1;
    }
    fclose(f);
    CHECK(MXPredFree(pred));
    free(out);
    free(blob);
    free(json);
    free(xr);
  }
  for (s = 0; s < steps; ++s)
    pos += (size_t)snprintf(line + pos, sizeof(line) - pos, "%s%.3f",
                            s ? ", " : "", step_ms[s]);
  snprintf(line + pos, sizeof(line) - pos,
           "], \"args\": %u, \"aux\": %u, \"rtc\": \"ok\"}", n_args, n_aux);
  CHECK(MXExecutorFree(exec));
  printf("%s\n", line);
  return 0;
}
