/*
 * lib_lightgbm_tpu_torch: the 48 LGBM_* entry points of the reference
 * c_api.h, each a forwarder into lightgbm_tpu_torch/capi/impl.py.
 *
 * No Python header is needed and libpython is not linked: the
 * interpreter is found at the first call (boot), by symbol.
 *
 *  - Loaded by a Python process (ctypes): Py_IsInitialized and the
 *    other entry points resolve through dlsym(RTLD_DEFAULT, ...).  The
 *    boot code runs under PyGILState_Ensure; no second interpreter.
 *  - Loaded by any other program: the libpython the build baked in is
 *    dlopen'ed with RTLD_GLOBAL, Py_InitializeEx(0) starts an interpreter
 *    that installs no signal handler, the boot code runs, and
 *    PyEval_SaveThread() lets any C thread enter it later.
 *
 * The boot code puts the build's sys.path and the repo root on sys.path
 * and calls impl.bind_library(<this library's path>), which hands one
 * ctypes callback per entry point to LGBM_TorchBind.  A forwarder then
 * calls its callback (ctypes takes the interpreter lock itself).  A boot
 * that fails makes every later call return -1 with the boot's error.
 *
 * LGBM_GetLastError never enters Python: the message is a thread-local
 * buffer that impl.py writes through LGBM_TorchSetLastError.
 *
 * Built by build.py with the host C compiler:
 *   cc -O2 -shared -fPIC -DLGBM_TORCH_LIBPYTHON=... -DLGBM_TORCH_PYTHONHOME=...
 *      -DLGBM_TORCH_BOOT_PATHS=... c_api.c -ldl -pthread
 */
#define _GNU_SOURCE
#include <dlfcn.h>
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <wchar.h>

#ifndef LGBM_TORCH_LIBPYTHON
#define LGBM_TORCH_LIBPYTHON ""
#endif
#ifndef LGBM_TORCH_PYTHONHOME
#define LGBM_TORCH_PYTHONHOME ""
#endif
/* a Python expression: the list of paths put first on sys.path */
#ifndef LGBM_TORCH_BOOT_PATHS
#define LGBM_TORCH_BOOT_PATHS "[]"
#endif

#define EXPORT __attribute__((visibility("default")))

typedef void* DatasetHandle;
typedef void* BoosterHandle;

/* the slots of LGBM_TorchBind's table: API_NAMES' order (cdef.py) */
enum {
  K_LGBM_GetLastError,
  K_LGBM_DatasetCreateFromFile,
  K_LGBM_DatasetCreateFromSampledColumn,
  K_LGBM_DatasetCreateByReference,
  K_LGBM_DatasetPushRows,
  K_LGBM_DatasetPushRowsByCSR,
  K_LGBM_DatasetCreateFromCSR,
  K_LGBM_DatasetCreateFromCSC,
  K_LGBM_DatasetCreateFromMat,
  K_LGBM_DatasetGetSubset,
  K_LGBM_DatasetSetFeatureNames,
  K_LGBM_DatasetGetFeatureNames,
  K_LGBM_DatasetFree,
  K_LGBM_DatasetSaveBinary,
  K_LGBM_DatasetSetField,
  K_LGBM_DatasetGetField,
  K_LGBM_DatasetGetNumData,
  K_LGBM_DatasetGetNumFeature,
  K_LGBM_BoosterCreate,
  K_LGBM_BoosterCreateFromModelfile,
  K_LGBM_BoosterLoadModelFromString,
  K_LGBM_BoosterFree,
  K_LGBM_BoosterMerge,
  K_LGBM_BoosterAddValidData,
  K_LGBM_BoosterResetTrainingData,
  K_LGBM_BoosterResetParameter,
  K_LGBM_BoosterGetNumClasses,
  K_LGBM_BoosterUpdateOneIter,
  K_LGBM_BoosterUpdateOneIterCustom,
  K_LGBM_BoosterRollbackOneIter,
  K_LGBM_BoosterGetCurrentIteration,
  K_LGBM_BoosterGetEvalCounts,
  K_LGBM_BoosterGetEvalNames,
  K_LGBM_BoosterGetFeatureNames,
  K_LGBM_BoosterGetNumFeature,
  K_LGBM_BoosterGetEval,
  K_LGBM_BoosterGetNumPredict,
  K_LGBM_BoosterGetPredict,
  K_LGBM_BoosterPredictForFile,
  K_LGBM_BoosterCalcNumPredict,
  K_LGBM_BoosterPredictForCSR,
  K_LGBM_BoosterPredictForCSC,
  K_LGBM_BoosterPredictForMat,
  K_LGBM_BoosterSaveModel,
  K_LGBM_BoosterSaveModelToString,
  K_LGBM_BoosterDumpModel,
  K_LGBM_BoosterGetLeafValue,
  K_LGBM_BoosterSetLeafValue,
  NUM_API
};

#define ERR_LEN 512

static void* table[NUM_API];
static int bound;                 /* every Python slot filled */
static pthread_once_t boot_once = PTHREAD_ONCE_INIT;
static int boot_rc = -1;
static char boot_error[ERR_LEN];
static __thread char last_error[ERR_LEN] = "Everything is fine";

static void set_error(char* dst, const char* msg) {
  snprintf(dst, ERR_LEN, "%s", msg ? msg : "(null)");
}

EXPORT const char* LGBM_GetLastError(void) { return last_error; }

/* impl.py writes a failed call's message here, on the caller's thread */
EXPORT void LGBM_TorchSetLastError(const char* msg) {
  set_error(last_error, msg);
}

/* impl.bind_library hands its callbacks over, in API_NAMES order; the
 * slot of LGBM_GetLastError stays NULL (it never enters Python).
 * Returns the number of callbacks taken, or -1 for a table of another
 * length. */
EXPORT int LGBM_TorchBind(void** fns, int n) {
  int i, taken = 0;
  if (n != NUM_API) return -1;
  for (i = 0; i < NUM_API; ++i) {
    table[i] = (i == K_LGBM_GetLastError) ? NULL : fns[i];
    taken += table[i] != NULL;
  }
  bound = taken == NUM_API - 1;
  return taken;
}

/* --- the boot ----------------------------------------------------------- */

typedef int (*is_init_fn)(void);
typedef void (*init_fn)(int);
typedef int (*gil_ensure_fn)(void);
typedef void (*gil_release_fn)(int);
typedef void* (*save_thread_fn)(void);
typedef int (*run_fn)(const char*);
typedef wchar_t* (*decode_fn)(const char*, size_t*);
typedef void (*set_home_fn)(const wchar_t*);

static const char BOOT_CODE[] =
    "def _lgbm_torch_boot(lib):\n"
    "    import sys\n"
    "    for p in reversed(%s):\n"
    "        if p not in sys.path:\n"
    "            sys.path.insert(0, p)\n"
    "    try:\n"
    "        from lightgbm_tpu_torch.capi import impl\n"
    "        impl.bind_library(lib)\n"
    "    except BaseException as exc:\n"
    "        import ctypes\n"
    "        ctypes.CDLL(lib).LGBM_TorchSetLastError(\n"
    "            ('C API boot failed: %%s: %%s' %% (type(exc).__name__, exc))\n"
    "            .encode('utf-8', 'replace'))\n"
    "_lgbm_torch_boot(b'%s'.decode('utf-8', 'surrogateescape'))\n"
    "del _lgbm_torch_boot\n";

/* this library's path as the body of a Python bytes literal */
static void escape_path(const char* path, char* out, size_t cap) {
  size_t j = 0;
  for (; *path && j + 4 < cap; ++path, j += 4)
    snprintf(out + j, 5, "\\x%02x", (unsigned char)*path);
  out[j] = '\0';
}

#define RESOLVE(var, type, handle, name)                                   \
  type var = (type)dlsym(handle, name);                                    \
  if (var == NULL) {                                                       \
    snprintf(boot_error, ERR_LEN, "C API boot failed: %s not found (%s)", \
             name, dlerror());                                             \
    return;                                                                \
  }

static void boot_once_fn(void) {
  Dl_info info;
  void* py = RTLD_DEFAULT;
  int embedded = 0;
  is_init_fn is_init = (is_init_fn)dlsym(RTLD_DEFAULT, "Py_IsInitialized");
  if (is_init == NULL || !is_init()) {
    if (is_init == NULL) {
      if (LGBM_TORCH_LIBPYTHON[0] == '\0') {
        set_error(boot_error, "C API boot failed: the build found no "
                              "shared libpython to load");
        return;
      }
      py = dlopen(LGBM_TORCH_LIBPYTHON, RTLD_NOW | RTLD_GLOBAL);
      if (py == NULL) {
        snprintf(boot_error, ERR_LEN, "C API boot failed: %s", dlerror());
        return;
      }
    }
    embedded = 1;
  }
  RESOLVE(init, init_fn, py, "Py_InitializeEx");
  RESOLVE(ensure, gil_ensure_fn, py, "PyGILState_Ensure");
  RESOLVE(release, gil_release_fn, py, "PyGILState_Release");
  RESOLVE(save_thread, save_thread_fn, py, "PyEval_SaveThread");
  RESOLVE(run, run_fn, py, "PyRun_SimpleString");
  if (!dladdr((void*)&LGBM_GetLastError, &info) || info.dli_fname == NULL) {
    set_error(boot_error, "C API boot failed: dladdr found no path for "
                          "this library");
    return;
  }
  size_t cap = 4 * strlen(info.dli_fname) + 1;
  size_t code_len = sizeof(BOOT_CODE) + strlen(LGBM_TORCH_BOOT_PATHS) + cap;
  char* lib = (char*)malloc(cap);
  char* code = (char*)malloc(code_len);
  if (lib == NULL || code == NULL) {
    free(lib);
    free(code);
    set_error(boot_error, "C API boot failed: out of memory");
    return;
  }
  escape_path(info.dli_fname, lib, cap);
  snprintf(code, code_len, BOOT_CODE, LGBM_TORCH_BOOT_PATHS, lib);
  free(lib);
  if (embedded) {
    /* the build's interpreter home, where this Python still takes one
     * (Py_SetPythonHome keeps the pointer: never freed) */
    decode_fn decode = (decode_fn)dlsym(py, "Py_DecodeLocale");
    set_home_fn set_home = (set_home_fn)dlsym(py, "Py_SetPythonHome");
    if (decode && set_home && LGBM_TORCH_PYTHONHOME[0] != '\0')
      set_home(decode(LGBM_TORCH_PYTHONHOME, NULL));
    init(0);
    run(code);
    save_thread();
  } else {
    int state = ensure();
    run(code);
    release(state);
  }
  free(code);
  if (bound) {
    boot_rc = 0;
  } else if (strcmp(last_error, "Everything is fine") != 0) {
    set_error(boot_error, last_error);
  } else {
    set_error(boot_error, "C API boot failed: the boot code raised "
                          "(its traceback is on stderr)");
  }
}

static int boot(void) {
  pthread_once(&boot_once, boot_once_fn);
  if (boot_rc != 0) set_error(last_error, boot_error);
  return boot_rc;
}

#define FORWARD(name, ...)                                       \
  do {                                                           \
    if (boot() != 0) return -1;                                  \
    return ((__typeof__(&name))table[K_##name])(__VA_ARGS__);    \
  } while (0)

/* --- the entry points (c_api.h; the prototypes of cdef.py's CDEF) ------- */

EXPORT int LGBM_DatasetCreateFromFile(const char* filename,
                                      const char* parameters,
                                      const DatasetHandle reference,
                                      DatasetHandle* out) {
  FORWARD(LGBM_DatasetCreateFromFile, filename, parameters, reference, out);
}

EXPORT int LGBM_DatasetCreateFromSampledColumn(double** sample_data,
                                               int** sample_indices,
                                               int32_t ncol,
                                               const int* num_per_col,
                                               int32_t num_sample_row,
                                               int32_t num_total_row,
                                               const char* parameters,
                                               DatasetHandle* out) {
  FORWARD(LGBM_DatasetCreateFromSampledColumn, sample_data, sample_indices,
          ncol, num_per_col, num_sample_row, num_total_row, parameters, out);
}

EXPORT int LGBM_DatasetCreateByReference(const DatasetHandle reference,
                                         int64_t num_total_row,
                                         DatasetHandle* out) {
  FORWARD(LGBM_DatasetCreateByReference, reference, num_total_row, out);
}

EXPORT int LGBM_DatasetPushRows(DatasetHandle dataset,
                                const void* data,
                                int data_type,
                                int32_t nrow,
                                int32_t ncol,
                                int32_t start_row) {
  FORWARD(LGBM_DatasetPushRows, dataset, data, data_type, nrow, ncol,
          start_row);
}

EXPORT int LGBM_DatasetPushRowsByCSR(DatasetHandle dataset,
                                     const void* indptr,
                                     int indptr_type,
                                     const int32_t* indices,
                                     const void* data,
                                     int data_type,
                                     int64_t nindptr,
                                     int64_t nelem,
                                     int64_t num_col,
                                     int64_t start_row) {
  FORWARD(LGBM_DatasetPushRowsByCSR, dataset, indptr, indptr_type, indices,
          data, data_type, nindptr, nelem, num_col, start_row);
}

EXPORT int LGBM_DatasetCreateFromCSR(const void* indptr,
                                     int indptr_type,
                                     const int32_t* indices,
                                     const void* data,
                                     int data_type,
                                     int64_t nindptr,
                                     int64_t nelem,
                                     int64_t num_col,
                                     const char* parameters,
                                     const DatasetHandle reference,
                                     DatasetHandle* out) {
  FORWARD(LGBM_DatasetCreateFromCSR, indptr, indptr_type, indices, data,
          data_type, nindptr, nelem, num_col, parameters, reference, out);
}

EXPORT int LGBM_DatasetCreateFromCSC(const void* col_ptr,
                                     int col_ptr_type,
                                     const int32_t* indices,
                                     const void* data,
                                     int data_type,
                                     int64_t ncol_ptr,
                                     int64_t nelem,
                                     int64_t num_row,
                                     const char* parameters,
                                     const DatasetHandle reference,
                                     DatasetHandle* out) {
  FORWARD(LGBM_DatasetCreateFromCSC, col_ptr, col_ptr_type, indices, data,
          data_type, ncol_ptr, nelem, num_row, parameters, reference, out);
}

EXPORT int LGBM_DatasetCreateFromMat(const void* data,
                                     int data_type,
                                     int32_t nrow,
                                     int32_t ncol,
                                     int is_row_major,
                                     const char* parameters,
                                     const DatasetHandle reference,
                                     DatasetHandle* out) {
  FORWARD(LGBM_DatasetCreateFromMat, data, data_type, nrow, ncol,
          is_row_major, parameters, reference, out);
}

EXPORT int LGBM_DatasetGetSubset(const DatasetHandle handle,
                                 const int32_t* used_row_indices,
                                 int32_t num_used_row_indices,
                                 const char* parameters,
                                 DatasetHandle* out) {
  FORWARD(LGBM_DatasetGetSubset, handle, used_row_indices,
          num_used_row_indices, parameters, out);
}

EXPORT int LGBM_DatasetSetFeatureNames(DatasetHandle handle,
                                       const char** feature_names,
                                       int num_feature_names) {
  FORWARD(LGBM_DatasetSetFeatureNames, handle, feature_names,
          num_feature_names);
}

EXPORT int LGBM_DatasetGetFeatureNames(DatasetHandle handle,
                                       char** feature_names,
                                       int* num_feature_names) {
  FORWARD(LGBM_DatasetGetFeatureNames, handle, feature_names,
          num_feature_names);
}

EXPORT int LGBM_DatasetFree(DatasetHandle handle) {
  FORWARD(LGBM_DatasetFree, handle);
}

EXPORT int LGBM_DatasetSaveBinary(DatasetHandle handle,
                                  const char* filename) {
  FORWARD(LGBM_DatasetSaveBinary, handle, filename);
}

EXPORT int LGBM_DatasetSetField(DatasetHandle handle,
                                const char* field_name,
                                const void* field_data,
                                int num_element,
                                int type) {
  FORWARD(LGBM_DatasetSetField, handle, field_name, field_data, num_element,
          type);
}

EXPORT int LGBM_DatasetGetField(DatasetHandle handle,
                                const char* field_name,
                                int* out_len,
                                const void** out_ptr,
                                int* out_type) {
  FORWARD(LGBM_DatasetGetField, handle, field_name, out_len, out_ptr,
          out_type);
}

EXPORT int LGBM_DatasetGetNumData(DatasetHandle handle, int* out) {
  FORWARD(LGBM_DatasetGetNumData, handle, out);
}

EXPORT int LGBM_DatasetGetNumFeature(DatasetHandle handle, int* out) {
  FORWARD(LGBM_DatasetGetNumFeature, handle, out);
}

EXPORT int LGBM_BoosterCreate(const DatasetHandle train_data,
                              const char* parameters,
                              BoosterHandle* out) {
  FORWARD(LGBM_BoosterCreate, train_data, parameters, out);
}

EXPORT int LGBM_BoosterCreateFromModelfile(const char* filename,
                                           int* out_num_iterations,
                                           BoosterHandle* out) {
  FORWARD(LGBM_BoosterCreateFromModelfile, filename, out_num_iterations,
          out);
}

EXPORT int LGBM_BoosterLoadModelFromString(const char* model_str,
                                           int* out_num_iterations,
                                           BoosterHandle* out) {
  FORWARD(LGBM_BoosterLoadModelFromString, model_str, out_num_iterations,
          out);
}

EXPORT int LGBM_BoosterFree(BoosterHandle handle) {
  FORWARD(LGBM_BoosterFree, handle);
}

EXPORT int LGBM_BoosterMerge(BoosterHandle handle,
                             BoosterHandle other_handle) {
  FORWARD(LGBM_BoosterMerge, handle, other_handle);
}

EXPORT int LGBM_BoosterAddValidData(BoosterHandle handle,
                                    const DatasetHandle valid_data) {
  FORWARD(LGBM_BoosterAddValidData, handle, valid_data);
}

EXPORT int LGBM_BoosterResetTrainingData(BoosterHandle handle,
                                         const DatasetHandle train_data) {
  FORWARD(LGBM_BoosterResetTrainingData, handle, train_data);
}

EXPORT int LGBM_BoosterResetParameter(BoosterHandle handle,
                                      const char* parameters) {
  FORWARD(LGBM_BoosterResetParameter, handle, parameters);
}

EXPORT int LGBM_BoosterGetNumClasses(BoosterHandle handle, int* out_len) {
  FORWARD(LGBM_BoosterGetNumClasses, handle, out_len);
}

EXPORT int LGBM_BoosterUpdateOneIter(BoosterHandle handle,
                                     int* is_finished) {
  FORWARD(LGBM_BoosterUpdateOneIter, handle, is_finished);
}

EXPORT int LGBM_BoosterUpdateOneIterCustom(BoosterHandle handle,
                                           const float* grad,
                                           const float* hess,
                                           int* is_finished) {
  FORWARD(LGBM_BoosterUpdateOneIterCustom, handle, grad, hess, is_finished);
}

EXPORT int LGBM_BoosterRollbackOneIter(BoosterHandle handle) {
  FORWARD(LGBM_BoosterRollbackOneIter, handle);
}

EXPORT int LGBM_BoosterGetCurrentIteration(BoosterHandle handle,
                                           int* out_iteration) {
  FORWARD(LGBM_BoosterGetCurrentIteration, handle, out_iteration);
}

EXPORT int LGBM_BoosterGetEvalCounts(BoosterHandle handle, int* out_len) {
  FORWARD(LGBM_BoosterGetEvalCounts, handle, out_len);
}

EXPORT int LGBM_BoosterGetEvalNames(BoosterHandle handle, int* out_len,
                                    char** out_strs) {
  FORWARD(LGBM_BoosterGetEvalNames, handle, out_len, out_strs);
}

EXPORT int LGBM_BoosterGetFeatureNames(BoosterHandle handle, int* out_len,
                                       char** out_strs) {
  FORWARD(LGBM_BoosterGetFeatureNames, handle, out_len, out_strs);
}

EXPORT int LGBM_BoosterGetNumFeature(BoosterHandle handle, int* out_len) {
  FORWARD(LGBM_BoosterGetNumFeature, handle, out_len);
}

EXPORT int LGBM_BoosterGetEval(BoosterHandle handle,
                               int data_idx,
                               int* out_len,
                               double* out_results) {
  FORWARD(LGBM_BoosterGetEval, handle, data_idx, out_len, out_results);
}

EXPORT int LGBM_BoosterGetNumPredict(BoosterHandle handle,
                                     int data_idx,
                                     int64_t* out_len) {
  FORWARD(LGBM_BoosterGetNumPredict, handle, data_idx, out_len);
}

EXPORT int LGBM_BoosterGetPredict(BoosterHandle handle,
                                  int data_idx,
                                  int64_t* out_len,
                                  double* out_result) {
  FORWARD(LGBM_BoosterGetPredict, handle, data_idx, out_len, out_result);
}

EXPORT int LGBM_BoosterPredictForFile(BoosterHandle handle,
                                      const char* data_filename,
                                      int data_has_header,
                                      int predict_type,
                                      int num_iteration,
                                      const char* result_filename) {
  FORWARD(LGBM_BoosterPredictForFile, handle, data_filename, data_has_header,
          predict_type, num_iteration, result_filename);
}

EXPORT int LGBM_BoosterCalcNumPredict(BoosterHandle handle,
                                      int num_row,
                                      int predict_type,
                                      int num_iteration,
                                      int64_t* out_len) {
  FORWARD(LGBM_BoosterCalcNumPredict, handle, num_row, predict_type,
          num_iteration, out_len);
}

EXPORT int LGBM_BoosterPredictForCSR(BoosterHandle handle,
                                     const void* indptr,
                                     int indptr_type,
                                     const int32_t* indices,
                                     const void* data,
                                     int data_type,
                                     int64_t nindptr,
                                     int64_t nelem,
                                     int64_t num_col,
                                     int predict_type,
                                     int num_iteration,
                                     int64_t* out_len,
                                     double* out_result) {
  FORWARD(LGBM_BoosterPredictForCSR, handle, indptr, indptr_type, indices,
          data, data_type, nindptr, nelem, num_col, predict_type,
          num_iteration, out_len, out_result);
}

EXPORT int LGBM_BoosterPredictForCSC(BoosterHandle handle,
                                     const void* col_ptr,
                                     int col_ptr_type,
                                     const int32_t* indices,
                                     const void* data,
                                     int data_type,
                                     int64_t ncol_ptr,
                                     int64_t nelem,
                                     int64_t num_row,
                                     int predict_type,
                                     int num_iteration,
                                     int64_t* out_len,
                                     double* out_result) {
  FORWARD(LGBM_BoosterPredictForCSC, handle, col_ptr, col_ptr_type, indices,
          data, data_type, ncol_ptr, nelem, num_row, predict_type,
          num_iteration, out_len, out_result);
}

EXPORT int LGBM_BoosterPredictForMat(BoosterHandle handle,
                                     const void* data,
                                     int data_type,
                                     int32_t nrow,
                                     int32_t ncol,
                                     int is_row_major,
                                     int predict_type,
                                     int num_iteration,
                                     int64_t* out_len,
                                     double* out_result) {
  FORWARD(LGBM_BoosterPredictForMat, handle, data, data_type, nrow, ncol,
          is_row_major, predict_type, num_iteration, out_len, out_result);
}

EXPORT int LGBM_BoosterSaveModel(BoosterHandle handle,
                                 int num_iteration,
                                 const char* filename) {
  FORWARD(LGBM_BoosterSaveModel, handle, num_iteration, filename);
}

EXPORT int LGBM_BoosterSaveModelToString(BoosterHandle handle,
                                         int num_iteration,
                                         int buffer_len,
                                         int* out_len,
                                         char* out_str) {
  FORWARD(LGBM_BoosterSaveModelToString, handle, num_iteration, buffer_len,
          out_len, out_str);
}

EXPORT int LGBM_BoosterDumpModel(BoosterHandle handle,
                                 int num_iteration,
                                 int buffer_len,
                                 int* out_len,
                                 char* out_str) {
  FORWARD(LGBM_BoosterDumpModel, handle, num_iteration, buffer_len, out_len,
          out_str);
}

EXPORT int LGBM_BoosterGetLeafValue(BoosterHandle handle,
                                    int tree_idx,
                                    int leaf_idx,
                                    double* out_val) {
  FORWARD(LGBM_BoosterGetLeafValue, handle, tree_idx, leaf_idx, out_val);
}

EXPORT int LGBM_BoosterSetLeafValue(BoosterHandle handle,
                                    int tree_idx,
                                    int leaf_idx,
                                    double val) {
  FORWARD(LGBM_BoosterSetLeafValue, handle, tree_idx, leaf_idx, val);
}
