"""C declarations of the LGBM_* API surface, and their ``ctypes`` types.

``CDEF`` and ``API_NAMES`` are the JAX package's (the reference
``include/LightGBM/c_api.h``, minus its export macro): the same names,
argument types and handle model, so a caller written against the
reference's ``lib_lightgbm.so`` can load the port's library instead.
``SIGNATURES`` is derived from ``CDEF`` by a small parser: each name's
return type and argument C types.  ``ctypes_of`` maps a C type to its
``ctypes`` type: ``impl.py`` makes its callbacks from them, and
``declare`` sets a loaded library's prototypes for a Python caller.
"""

import ctypes
import re
from typing import Dict, List, Tuple

CDEF = r"""
typedef void* DatasetHandle;
typedef void* BoosterHandle;

const char* LGBM_GetLastError();

int LGBM_DatasetCreateFromFile(const char* filename,
                               const char* parameters,
                               const DatasetHandle reference,
                               DatasetHandle* out);

int LGBM_DatasetCreateFromSampledColumn(double** sample_data,
                                        int** sample_indices,
                                        int32_t ncol,
                                        const int* num_per_col,
                                        int32_t num_sample_row,
                                        int32_t num_total_row,
                                        const char* parameters,
                                        DatasetHandle* out);

int LGBM_DatasetCreateByReference(const DatasetHandle reference,
                                  int64_t num_total_row,
                                  DatasetHandle* out);

int LGBM_DatasetPushRows(DatasetHandle dataset,
                         const void* data,
                         int data_type,
                         int32_t nrow,
                         int32_t ncol,
                         int32_t start_row);

int LGBM_DatasetPushRowsByCSR(DatasetHandle dataset,
                              const void* indptr,
                              int indptr_type,
                              const int32_t* indices,
                              const void* data,
                              int data_type,
                              int64_t nindptr,
                              int64_t nelem,
                              int64_t num_col,
                              int64_t start_row);

int LGBM_DatasetCreateFromCSR(const void* indptr,
                              int indptr_type,
                              const int32_t* indices,
                              const void* data,
                              int data_type,
                              int64_t nindptr,
                              int64_t nelem,
                              int64_t num_col,
                              const char* parameters,
                              const DatasetHandle reference,
                              DatasetHandle* out);

int LGBM_DatasetCreateFromCSC(const void* col_ptr,
                              int col_ptr_type,
                              const int32_t* indices,
                              const void* data,
                              int data_type,
                              int64_t ncol_ptr,
                              int64_t nelem,
                              int64_t num_row,
                              const char* parameters,
                              const DatasetHandle reference,
                              DatasetHandle* out);

int LGBM_DatasetCreateFromMat(const void* data,
                              int data_type,
                              int32_t nrow,
                              int32_t ncol,
                              int is_row_major,
                              const char* parameters,
                              const DatasetHandle reference,
                              DatasetHandle* out);

int LGBM_DatasetGetSubset(const DatasetHandle handle,
                          const int32_t* used_row_indices,
                          int32_t num_used_row_indices,
                          const char* parameters,
                          DatasetHandle* out);

int LGBM_DatasetSetFeatureNames(DatasetHandle handle,
                                const char** feature_names,
                                int num_feature_names);

int LGBM_DatasetGetFeatureNames(DatasetHandle handle,
                                char** feature_names,
                                int* num_feature_names);

int LGBM_DatasetFree(DatasetHandle handle);

int LGBM_DatasetSaveBinary(DatasetHandle handle,
                           const char* filename);

int LGBM_DatasetSetField(DatasetHandle handle,
                         const char* field_name,
                         const void* field_data,
                         int num_element,
                         int type);

int LGBM_DatasetGetField(DatasetHandle handle,
                         const char* field_name,
                         int* out_len,
                         const void** out_ptr,
                         int* out_type);

int LGBM_DatasetGetNumData(DatasetHandle handle, int* out);

int LGBM_DatasetGetNumFeature(DatasetHandle handle, int* out);

int LGBM_BoosterCreate(const DatasetHandle train_data,
                       const char* parameters,
                       BoosterHandle* out);

int LGBM_BoosterCreateFromModelfile(const char* filename,
                                    int* out_num_iterations,
                                    BoosterHandle* out);

int LGBM_BoosterLoadModelFromString(const char* model_str,
                                    int* out_num_iterations,
                                    BoosterHandle* out);

int LGBM_BoosterFree(BoosterHandle handle);

int LGBM_BoosterMerge(BoosterHandle handle,
                      BoosterHandle other_handle);

int LGBM_BoosterAddValidData(BoosterHandle handle,
                             const DatasetHandle valid_data);

int LGBM_BoosterResetTrainingData(BoosterHandle handle,
                                  const DatasetHandle train_data);

int LGBM_BoosterResetParameter(BoosterHandle handle, const char* parameters);

int LGBM_BoosterGetNumClasses(BoosterHandle handle, int* out_len);

int LGBM_BoosterUpdateOneIter(BoosterHandle handle, int* is_finished);

int LGBM_BoosterUpdateOneIterCustom(BoosterHandle handle,
                                    const float* grad,
                                    const float* hess,
                                    int* is_finished);

int LGBM_BoosterRollbackOneIter(BoosterHandle handle);

int LGBM_BoosterGetCurrentIteration(BoosterHandle handle, int* out_iteration);

int LGBM_BoosterGetEvalCounts(BoosterHandle handle, int* out_len);

int LGBM_BoosterGetEvalNames(BoosterHandle handle, int* out_len, char** out_strs);

int LGBM_BoosterGetFeatureNames(BoosterHandle handle, int* out_len, char** out_strs);

int LGBM_BoosterGetNumFeature(BoosterHandle handle, int* out_len);

int LGBM_BoosterGetEval(BoosterHandle handle,
                        int data_idx,
                        int* out_len,
                        double* out_results);

int LGBM_BoosterGetNumPredict(BoosterHandle handle,
                              int data_idx,
                              int64_t* out_len);

int LGBM_BoosterGetPredict(BoosterHandle handle,
                           int data_idx,
                           int64_t* out_len,
                           double* out_result);

int LGBM_BoosterPredictForFile(BoosterHandle handle,
                               const char* data_filename,
                               int data_has_header,
                               int predict_type,
                               int num_iteration,
                               const char* result_filename);

int LGBM_BoosterCalcNumPredict(BoosterHandle handle,
                               int num_row,
                               int predict_type,
                               int num_iteration,
                               int64_t* out_len);

int LGBM_BoosterPredictForCSR(BoosterHandle handle,
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
                              double* out_result);

int LGBM_BoosterPredictForCSC(BoosterHandle handle,
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
                              double* out_result);

int LGBM_BoosterPredictForMat(BoosterHandle handle,
                              const void* data,
                              int data_type,
                              int32_t nrow,
                              int32_t ncol,
                              int is_row_major,
                              int predict_type,
                              int num_iteration,
                              int64_t* out_len,
                              double* out_result);

int LGBM_BoosterSaveModel(BoosterHandle handle,
                          int num_iteration,
                          const char* filename);

int LGBM_BoosterSaveModelToString(BoosterHandle handle,
                                  int num_iteration,
                                  int buffer_len,
                                  int* out_len,
                                  char* out_str);

int LGBM_BoosterDumpModel(BoosterHandle handle,
                          int num_iteration,
                          int buffer_len,
                          int* out_len,
                          char* out_str);

int LGBM_BoosterGetLeafValue(BoosterHandle handle,
                             int tree_idx,
                             int leaf_idx,
                             double* out_val);

int LGBM_BoosterSetLeafValue(BoosterHandle handle,
                             int tree_idx,
                             int leaf_idx,
                             double val);
"""

API_NAMES = [
    "LGBM_GetLastError",
    "LGBM_DatasetCreateFromFile",
    "LGBM_DatasetCreateFromSampledColumn",
    "LGBM_DatasetCreateByReference",
    "LGBM_DatasetPushRows",
    "LGBM_DatasetPushRowsByCSR",
    "LGBM_DatasetCreateFromCSR",
    "LGBM_DatasetCreateFromCSC",
    "LGBM_DatasetCreateFromMat",
    "LGBM_DatasetGetSubset",
    "LGBM_DatasetSetFeatureNames",
    "LGBM_DatasetGetFeatureNames",
    "LGBM_DatasetFree",
    "LGBM_DatasetSaveBinary",
    "LGBM_DatasetSetField",
    "LGBM_DatasetGetField",
    "LGBM_DatasetGetNumData",
    "LGBM_DatasetGetNumFeature",
    "LGBM_BoosterCreate",
    "LGBM_BoosterCreateFromModelfile",
    "LGBM_BoosterLoadModelFromString",
    "LGBM_BoosterFree",
    "LGBM_BoosterMerge",
    "LGBM_BoosterAddValidData",
    "LGBM_BoosterResetTrainingData",
    "LGBM_BoosterResetParameter",
    "LGBM_BoosterGetNumClasses",
    "LGBM_BoosterUpdateOneIter",
    "LGBM_BoosterUpdateOneIterCustom",
    "LGBM_BoosterRollbackOneIter",
    "LGBM_BoosterGetCurrentIteration",
    "LGBM_BoosterGetEvalCounts",
    "LGBM_BoosterGetEvalNames",
    "LGBM_BoosterGetFeatureNames",
    "LGBM_BoosterGetNumFeature",
    "LGBM_BoosterGetEval",
    "LGBM_BoosterGetNumPredict",
    "LGBM_BoosterGetPredict",
    "LGBM_BoosterPredictForFile",
    "LGBM_BoosterCalcNumPredict",
    "LGBM_BoosterPredictForCSR",
    "LGBM_BoosterPredictForCSC",
    "LGBM_BoosterPredictForMat",
    "LGBM_BoosterSaveModel",
    "LGBM_BoosterSaveModelToString",
    "LGBM_BoosterDumpModel",
    "LGBM_BoosterGetLeafValue",
    "LGBM_BoosterSetLeafValue",
]


_DECL = re.compile(r"^\s*([\w\s\*]+?[\s\*])(LGBM_\w+)\s*\(([^)]*)\)\s*;",
                   re.M)


def _arg_type(arg: str) -> str:
    """The C type of one declared argument: its name dropped, ``const``
    kept, pointer stars normalised (``const char** x`` ->
    ``const char**``)."""
    arg = " ".join(arg.split())
    m = re.match(r"^(.*?)([\s\*]+)(\w+)$", arg)
    if m is None:
        raise ValueError(f"cannot parse C argument {arg!r}")
    base, stars = m.group(1).strip(), m.group(2).count("*")
    return base + "*" * stars


def _parse(cdef: str) -> Dict[str, Tuple[str, List[str]]]:
    out: Dict[str, Tuple[str, List[str]]] = {}
    for m in _DECL.finditer(cdef):
        ret = " ".join(m.group(1).split()).replace(" *", "*")
        args = [a for a in (x.strip() for x in m.group(3).split(",")) if a]
        out[m.group(2)] = (ret, [_arg_type(a) for a in args])
    return out


#: name -> (return C type, [argument C types]), for every ``API_NAMES``
SIGNATURES: Dict[str, Tuple[str, List[str]]] = _parse(CDEF)

_SCALARS = {"int": ctypes.c_int, "int32_t": ctypes.c_int32,
            "int64_t": ctypes.c_int64, "double": ctypes.c_double,
            "float": ctypes.c_float, "char": ctypes.c_char,
            "void": None}
_HANDLES = ("DatasetHandle", "BoosterHandle")


def ctypes_of(ctype: str):
    """The ``ctypes`` type of a C type of ``CDEF``: handles and
    ``void*`` are ``c_void_p``, ``char*`` an address (``c_void_p``: an
    output buffer or a string read with ``string_at``), ``char**`` a
    ``POINTER(c_char_p)``, any other pointer a ``POINTER`` of its
    pointee."""
    t = ctype.replace("const ", "").strip()
    stars = t.count("*")
    base = t.rstrip("*").strip()
    if base in _HANDLES:
        base, stars = "void", stars + 1
    if stars == 0:
        return _SCALARS[base]
    if base == "void" and stars == 1 or base == "char" and stars == 1:
        return ctypes.c_void_p
    if base == "char" and stars == 2:
        return ctypes.POINTER(ctypes.c_char_p)
    if base == "void":          # void** -> POINTER(c_void_p)
        inner, stars = ctypes.c_void_p, stars - 1
    else:
        inner = _SCALARS[base]
    for _ in range(stars):
        inner = ctypes.POINTER(inner)
    return inner


def declare(lib) -> None:
    """Set ``argtypes`` and ``restype`` of every ``API_NAMES`` function
    of a loaded library (``ctypes.CDLL``) for a Python caller: C strings
    given as ``bytes`` (``c_char_p``), every other type as
    :func:`ctypes_of` maps it; ``LGBM_GetLastError`` returns ``bytes``."""
    for name in API_NAMES:
        ret, args = SIGNATURES[name]
        fn = getattr(lib, name)
        fn.restype = ctypes.c_char_p if ret == "const char*" \
            else ctypes_of(ret)
        fn.argtypes = [ctypes.c_char_p if a == "const char*"
                       else ctypes_of(a) for a in args]
