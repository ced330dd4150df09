// Embeddable C ABI for the PyTorch/CUDA stereo engine (counterpart of
// stereovision_tpu/csrc/svtpu_capi.cpp).
//
// The reference exports its pipeline from a shared library as
//   extern "C" Double3 *generatePointCloud(uchar *left, uchar *right, ...)
//   void clean()
// (src/serial_includes/main/stereo_vision.cpp:565-623 and :106-114), which
// both its Python pip wrapper (ctypes, stereo_vision/sv.py:164-192) and any
// C/C++ application consume.  This file keeps that exact surface for the
// port: stereovision_tpu_torch.capi.library_path() builds it at first use
// (g++, against the running interpreter's libpython) into
// build/stereovision_tpu_torch/.  The library embeds CPython (or joins an
// already-running interpreter when loaded via ctypes) and forwards every
// call to stereovision_tpu_torch.capi.  All torch/CUDA work stays on the
// Python side; this shim only owns interpreter lifecycle, the GIL, and
// pointer marshalling.
//
// Consumer notes:
//  - dlopen with RTLD_GLOBAL so numpy/torch extension modules resolve
//    libpython symbols (standard embedding requirement).
//  - When the hosting process is not a Python process, set PYTHONPATH to
//    the directory holding stereovision_tpu_torch and the site-packages
//    holding torch before the first call.
//  - The returned pointer addresses a (pc_w*pc_h, 3) float64 array owned
//    by the library; it stays valid until the next generatePointCloud()
//    or clean() — the same lifetime contract as the reference's static
//    `points` buffer.

#include <Python.h>

#include <cstdio>

static bool g_we_initialized = false;
static PyObject *g_mod = nullptr;  // stereovision_tpu_torch.capi, owned ref

static void ensure_python() {
    if (!Py_IsInitialized()) {
        Py_InitializeEx(0);
        g_we_initialized = true;
        // Release the GIL acquired by initialization so every entry point
        // (from any thread) can use the PyGILState API uniformly.
        PyEval_SaveThread();
    }
}

extern "C" {

double *generatePointCloud(unsigned char *left, unsigned char *right,
                           char *camera_calibration_yaml,
                           int width, int height,
                           bool kitti_calibration, bool object_tracking,
                           bool graphics, bool display,
                           int scale, int pc_extrapolation,
                           const char *yolo_cfg, const char *yolo_weights,
                           const char *yolo_classes,
                           bool remove_sky, bool subsampling) {
    ensure_python();
    PyGILState_STATE gs = PyGILState_Ensure();
    double *out = nullptr;
    do {
        if (!g_mod) {
            g_mod = PyImport_ImportModule("stereovision_tpu_torch.capi");
            if (!g_mod) {
                PyErr_Print();
                break;
            }
        }
        Py_ssize_t nbytes = (Py_ssize_t)width * height * 4;  // CV_8UC4
        PyObject *l = PyMemoryView_FromMemory(
            reinterpret_cast<char *>(left), nbytes, PyBUF_READ);
        PyObject *r = PyMemoryView_FromMemory(
            reinterpret_cast<char *>(right), nbytes, PyBUF_READ);
        PyObject *res =
            l && r ? PyObject_CallMethod(
                         g_mod, "generate", "OOsiiiiiiiisssii", l, r,
                         camera_calibration_yaml ? camera_calibration_yaml
                                                 : "",
                         width, height, (int)kitti_calibration,
                         (int)object_tracking, (int)graphics, (int)display,
                         scale, pc_extrapolation, yolo_cfg ? yolo_cfg : "",
                         yolo_weights ? yolo_weights : "",
                         yolo_classes ? yolo_classes : "", (int)remove_sky,
                         (int)subsampling)
                   : nullptr;
        Py_XDECREF(l);
        Py_XDECREF(r);
        if (!res) {
            PyErr_Print();
            break;
        }
        out = reinterpret_cast<double *>(PyLong_AsVoidPtr(res));
        Py_DECREF(res);
        if (PyErr_Occurred()) {
            PyErr_Print();
            out = nullptr;
        }
    } while (false);
    PyGILState_Release(gs);
    return out;
}

unsigned char *getColor(void) {
    // reference getColor() (stereo_vision.cpp:626-628): per-point BGRA
    // colors of the last frame; null before the first generatePointCloud
    if (!Py_IsInitialized() || !g_mod)
        return nullptr;
    PyGILState_STATE gs = PyGILState_Ensure();
    unsigned char *out = nullptr;
    PyObject *res = PyObject_CallMethod(g_mod, "get_color", nullptr);
    if (!res) {
        PyErr_Print();
    } else {
        out = reinterpret_cast<unsigned char *>(PyLong_AsVoidPtr(res));
        Py_DECREF(res);
    }
    PyGILState_Release(gs);
    return out;
}

void clean(void) {
    if (!Py_IsInitialized())
        return;
    PyGILState_STATE gs = PyGILState_Ensure();
    if (g_mod) {
        PyObject *r = PyObject_CallMethod(g_mod, "clean", nullptr);
        if (!r)
            PyErr_Print();
        else
            Py_DECREF(r);
        Py_CLEAR(g_mod);
    }
    PyGILState_Release(gs);
    // Deliberately no Py_FinalizeEx(): torch's and CUDA's runtime state
    // does not survive interpreter teardown mid-process, and the
    // reference's clean() likewise leaves the process alive
    // (stereo_vision.cpp:106-114 frees pipeline state only).  A later
    // generatePointCloud() re-imports and re-initializes the engine.
}

}  // extern "C"
