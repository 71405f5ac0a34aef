/*
 * A C program that trains and predicts through lib_lightgbm_tpu_torch,
 * loaded with dlopen (it links nothing else):
 *
 *   capi_demo <library.so> <train.f64> <test.f64> <num_features>
 *             "<parameters>" <rounds> <model_out> <pred_out>
 *
 * A .f64 file holds rows of 1 + num_features doubles, the label first,
 * native byte order.  The program creates a dataset from the training
 * rows (LGBM_DatasetCreateFromMat, the label by LGBM_DatasetSetField),
 * creates a booster with the same parameters, runs <rounds> x
 * LGBM_BoosterUpdateOneIter, saves the model (LGBM_BoosterSaveModel),
 * predicts the test rows (LGBM_BoosterPredictForMat, normal scores) and
 * writes them to <pred_out> as raw doubles.  Its first call boots the
 * interpreter inside this process.  It prints one JSON line: the boot's
 * seconds, the dataset's, each round's, the predict's, and the mean
 * microseconds of a LGBM_BoosterGetCurrentIteration round trip.
 * Any failure prints LGBM_GetLastError() and exits 1.
 */
#include <dlfcn.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <time.h>

typedef void* Handle;
typedef const char* (*last_error_fn)(void);
typedef int (*num_data_fn)(Handle, int*);
typedef int (*from_mat_fn)(const void*, int, int32_t, int32_t, int,
                           const char*, const Handle, Handle*);
typedef int (*set_field_fn)(Handle, const char*, const void*, int, int);
typedef int (*booster_create_fn)(const Handle, const char*, Handle*);
typedef int (*update_fn)(Handle, int*);
typedef int (*iteration_fn)(Handle, int*);
typedef int (*save_fn)(Handle, int, const char*);
typedef int (*predict_mat_fn)(Handle, const void*, int, int32_t, int32_t,
                              int, int, int, int64_t*, double*);

#define CALL_REPS 1000
#define MAX_ROUNDS 64

static last_error_fn last_error;

static double now(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + 1e-9 * ts.tv_nsec;
}

static void fail(const char* what) {
  fprintf(stderr, "capi_demo: %s failed: %s\n", what,
          last_error ? last_error() : dlerror());
  exit(1);
}

static void* sym(void* lib, const char* name) {
  void* f = dlsym(lib, name);
  if (f == NULL) fail(name);
  return f;
}

/* rows of 1 + nf doubles: X [n, nf] row-major, y [n] as float */
static int64_t read_rows(const char* path, int nf, double** X, float** y) {
  FILE* fh = fopen(path, "rb");
  if (fh == NULL) {
    fprintf(stderr, "capi_demo: cannot open %s\n", path);
    exit(1);
  }
  fseek(fh, 0, SEEK_END);
  int64_t n = ftell(fh) / (int64_t)(sizeof(double) * (nf + 1));
  fseek(fh, 0, SEEK_SET);
  double* row = (double*)malloc(sizeof(double) * (nf + 1));
  *X = (double*)malloc(sizeof(double) * n * nf);
  *y = (float*)malloc(sizeof(float) * n);
  if (row == NULL || *X == NULL || *y == NULL) {
    fprintf(stderr, "capi_demo: out of memory\n");
    exit(1);
  }
  for (int64_t i = 0; i < n; ++i) {
    if (fread(row, sizeof(double), nf + 1, fh) != (size_t)(nf + 1)) {
      fprintf(stderr, "capi_demo: short read in %s\n", path);
      exit(1);
    }
    (*y)[i] = (float)row[0];
    for (int j = 0; j < nf; ++j) (*X)[i * nf + j] = row[1 + j];
  }
  free(row);
  fclose(fh);
  return n;
}

int main(int argc, char** argv) {
  if (argc != 9) {
    fprintf(stderr,
            "usage: %s <library.so> <train.f64> <test.f64> <num_features> "
            "<parameters> <rounds> <model_out> <pred_out>\n", argv[0]);
    return 2;
  }
  const char* params = argv[5];
  int nf = atoi(argv[4]);
  int rounds = atoi(argv[6]);
  if (rounds < 0 || rounds > MAX_ROUNDS) rounds = MAX_ROUNDS;
  void* lib = dlopen(argv[1], RTLD_NOW | RTLD_LOCAL);
  if (lib == NULL) fail("dlopen");
  last_error = (last_error_fn)sym(lib, "LGBM_GetLastError");
  num_data_fn num_data = (num_data_fn)sym(lib, "LGBM_DatasetGetNumData");
  from_mat_fn from_mat = (from_mat_fn)sym(lib, "LGBM_DatasetCreateFromMat");
  set_field_fn set_field = (set_field_fn)sym(lib, "LGBM_DatasetSetField");
  booster_create_fn create =
      (booster_create_fn)sym(lib, "LGBM_BoosterCreate");
  update_fn update = (update_fn)sym(lib, "LGBM_BoosterUpdateOneIter");
  iteration_fn iteration =
      (iteration_fn)sym(lib, "LGBM_BoosterGetCurrentIteration");
  save_fn save = (save_fn)sym(lib, "LGBM_BoosterSaveModel");
  predict_mat_fn predict =
      (predict_mat_fn)sym(lib, "LGBM_BoosterPredictForMat");

  double *X, *Xt;
  float *y, *yt;
  int64_t n = read_rows(argv[2], nf, &X, &y);
  int64_t nt = read_rows(argv[3], nf, &Xt, &yt);

  /* the first call boots the interpreter; a NULL handle then fails */
  int out = 0;
  double t0 = now();
  num_data(NULL, &out);
  double boot_s = now() - t0;

  Handle ds = NULL, booster = NULL;
  t0 = now();
  if (from_mat(X, 1, (int32_t)n, nf, 1, params, NULL, &ds) != 0)
    fail("LGBM_DatasetCreateFromMat");
  if (set_field(ds, "label", y, (int)n, 0) != 0) fail("LGBM_DatasetSetField");
  double dataset_s = now() - t0;
  if (create(ds, params, &booster) != 0) fail("LGBM_BoosterCreate");

  double round_s[MAX_ROUNDS];
  int finished = 0;
  for (int r = 0; r < rounds; ++r) {
    t0 = now();
    if (update(booster, &finished) != 0) fail("LGBM_BoosterUpdateOneIter");
    round_s[r] = now() - t0;
  }
  if (save(booster, -1, argv[7]) != 0) fail("LGBM_BoosterSaveModel");

  double* pred = (double*)malloc(sizeof(double) * nt);
  int64_t len = 0;
  t0 = now();
  if (predict(booster, Xt, 1, (int32_t)nt, nf, 1, 0, -1, &len, pred) != 0)
    fail("LGBM_BoosterPredictForMat");
  double predict_s = now() - t0;
  FILE* fh = fopen(argv[8], "wb");
  if (fh == NULL || fwrite(pred, sizeof(double), len, fh) != (size_t)len) {
    fprintf(stderr, "capi_demo: cannot write %s\n", argv[8]);
    return 1;
  }
  fclose(fh);

  t0 = now();
  for (int i = 0; i < CALL_REPS; ++i)
    if (iteration(booster, &out) != 0)
      fail("LGBM_BoosterGetCurrentIteration");
  double call_us = (now() - t0) / CALL_REPS * 1e6;

  printf("{\"boot_s\": %.6f, \"dataset_s\": %.6f, \"round_s\": [",
         boot_s, dataset_s);
  for (int r = 0; r < rounds; ++r)
    printf("%s%.6f", r ? ", " : "", round_s[r]);
  printf("], \"predict_s\": %.6f, \"call_us\": %.3f, \"rows\": %lld, "
         "\"test_rows\": %lld, \"iteration\": %d}\n",
         predict_s, call_us, (long long)n, (long long)nt, out);
  fflush(stdout);
  return 0;
}
