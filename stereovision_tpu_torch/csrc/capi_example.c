/* A C program that drives the port's C ABI with no Python of its own:
 * it dlopens the library (stereovision_tpu_torch.capi.library_path()),
 * which boots CPython and imports the port, and runs two frames of
 * width x height, each from a new buffer freed after the call; it checks
 * that each cloud has finite points and that getColor() returns each
 * frame's left BGRA pixels, then calls clean().
 *
 *   gcc capi_example.c -o capi_example -ldl -lm
 *   PYTHONPATH=<repo root>:<site-packages with torch> \
 *       ./capi_example <library> <width> <height>
 *
 * Prints "CAPI OK finite=<n0>,<n1> colors=<c0>,<c1>"; exits 0 when both
 * frames pass.
 */
#include <dlfcn.h>
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

typedef double *(*gen_fn)(unsigned char *, unsigned char *, char *,
                          int, int, int, int, int, int, int, int,
                          const char *, const char *, const char *,
                          int, int);

/* a textured left frame and the right one shifted by D columns */
static void frame(unsigned char *L, unsigned char *R, int W, int H,
                  int D, unsigned int s) {
    for (int v = 0; v < H; v++)
        for (int u = 0; u < W; u++) {
            s = s * 1664525u + 1013904223u;        /* LCG */
            for (int c = 0; c < 3; c++)
                L[(v * W + u) * 4 + c] = (unsigned char)(s >> 24);
            L[(v * W + u) * 4 + 3] = 255;
        }
    for (int v = 0; v < H; v++)
        for (int u = 0; u < W; u++)
            memcpy(R + (v * W + u) * 4, L + (v * W + (u + D) % W) * 4, 4);
}

int main(int argc, char **argv) {
    int W = atoi(argv[2]), H = atoi(argv[3]);
    void *h = dlopen(argv[1], RTLD_NOW | RTLD_GLOBAL);
    if (!h) { fprintf(stderr, "dlopen: %s\n", dlerror()); return 2; }
    gen_fn gen = (gen_fn)dlsym(h, "generatePointCloud");
    unsigned char *(*color)(void) =
        (unsigned char *(*)(void))dlsym(h, "getColor");
    void (*cln)(void) = (void (*)(void))dlsym(h, "clean");
    if (!gen || !color || !cln) { fprintf(stderr, "dlsym\n"); return 2; }
    int finite[2] = {0, 0}, same_color[2] = {0, 0};
    for (int k = 0; k < 2; k++) {
        /* a new buffer each frame, freed after the call */
        unsigned char *L = malloc(W * H * 4), *R = malloc(W * H * 4);
        frame(L, R, W, H, 7 + k, 12345u + k);
        double *pts = gen(L, R, (char *)"", W, H, 1, 0, 0, 0, 1, 1,
                          "", "", "", 0, 0);
        if (!pts) { fprintf(stderr, "null cloud %d\n", k); return 3; }
        for (int i = 0; i < W * H * 3; i++)
            finite[k] += isfinite(pts[i]) != 0;
        unsigned char *c = color();
        same_color[k] = c && memcmp(c, L, W * H * 4) == 0;
        free(L);
        free(R);
    }
    cln();
    printf("CAPI OK finite=%d,%d colors=%d,%d\n", finite[0], finite[1],
           same_color[0], same_color[1]);
    return (finite[0] > 0 && finite[1] > 0 && same_color[0]
            && same_color[1]) ? 0 : 4;
}
