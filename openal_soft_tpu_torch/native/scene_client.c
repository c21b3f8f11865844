/* A game's scene through the C ABI: builds a voice scene from a scene file
 * with the classic OpenAL calls, renders it with alcRenderSamplesSOFT and
 * writes the rendered frames.
 *
 *     scene_client <scene file> <output file>
 *
 * The scene file (little-endian; native/scene.py writes it with numpy):
 *   char[8]  "ALSCENE1"
 *   int32    rate, hrtf (0/1), n_tones, tone_len, n_voices, frames, calls
 *   float32  tones[n_tones][tone_len]        one mono buffer per tone
 *   per voice: int32 tone, int32 has_pitch, float64 x, y, z, pitch
 *
 * The device is a loopback device shaped by alcCreateContext's attributes
 * (ALC_FREQUENCY, stereo float32, ALC_HRTF_SOFT, ALC_MONO_SOURCES =
 * n_voices).  The calls come in the order of a C game's scene set-up:
 * every buffer (alGenBuffers, alBufferData), then per voice alGenSources,
 * AL_BUFFER, AL_LOOPING, AL_POSITION (alSource3dSOFT, so the positions
 * keep their double precision), AL_PITCH where given (alSourcedSOFT) and
 * alSourcePlay.  Then `calls` renders of `frames` frames each, all written
 * to the output file as interleaved float32 stereo.
 *
 * Prints BUILD_S=<s>, one RENDER_S=<s> per call and AL_ERROR=<code>; exits
 * non-zero if the device does not open or an AL error is pending.
 */
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#define AL_BUFFER 0x1009
#define AL_LOOPING 0x1007
#define AL_POSITION 0x1004
#define AL_PITCH 0x1003
#define AL_FORMAT_MONO_FLOAT32 0x10010
#define ALC_FREQUENCY 0x1007
#define ALC_MONO_SOURCES 0x1010
#define ALC_FORMAT_CHANNELS_SOFT 0x1990
#define ALC_FORMAT_TYPE_SOFT 0x1991
#define ALC_HRTF_SOFT 0x1992
#define ALC_STEREO_SOFT 0x1501
#define ALC_FLOAT_SOFT 0x1406

typedef void ALCdevice;
typedef void ALCcontext;
extern ALCdevice *alcLoopbackOpenDeviceSOFT(const char *devname);
extern ALCcontext *alcCreateContext(ALCdevice *dev, const int *attrs);
extern char alcMakeContextCurrent(ALCcontext *ctx);
extern void alcRenderSamplesSOFT(ALCdevice *dev, void *buffer, int samples);
extern void alGenBuffers(int n, unsigned *buffers);
extern void alBufferData(unsigned buffer, int format, const void *data,
                         int size, int freq);
extern void alGenSources(int n, unsigned *sources);
extern void alSourcei(unsigned source, int param, int value);
extern void alSource3dSOFT(unsigned source, int param, double x, double y,
                           double z);
extern void alSourcedSOFT(unsigned source, int param, double value);
extern void alSourcePlay(unsigned source);
extern int alGetError(void);

struct Voice {
    int32_t tone, has_pitch;
    double x, y, z, pitch;
};

static double now_s(void)
{
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
}

static int read_exact(FILE *fh, void *dst, size_t n)
{
    return fread(dst, 1, n, fh) == n;
}

int main(int argc, char **argv)
{
    if(argc != 3) {
        fprintf(stderr, "usage: %s <scene file> <output file>\n", argv[0]);
        return 2;
    }
    FILE *fh = fopen(argv[1], "rb");
    if(!fh) { perror(argv[1]); return 2; }
    char magic[8];
    int32_t hdr[7];
    if(!read_exact(fh, magic, 8) || memcmp(magic, "ALSCENE1", 8) != 0
       || !read_exact(fh, hdr, sizeof(hdr))) {
        fprintf(stderr, "%s: not a scene file\n", argv[1]);
        return 2;
    }
    const int rate = hdr[0], hrtf = hdr[1], n_tones = hdr[2];
    const int tone_len = hdr[3], n_voices = hdr[4], frames = hdr[5];
    const int calls = hdr[6];
    float *tones = malloc(sizeof(float) * (size_t)n_tones * tone_len);
    struct Voice *voices = malloc(sizeof(struct Voice) * (size_t)n_voices);
    if(!tones || !voices
       || !read_exact(fh, tones, sizeof(float) * (size_t)n_tones * tone_len)
       || !read_exact(fh, voices, sizeof(struct Voice) * (size_t)n_voices)) {
        fprintf(stderr, "%s: truncated scene file\n", argv[1]);
        return 2;
    }
    fclose(fh);

    const double t0 = now_s();
    ALCdevice *dev = alcLoopbackOpenDeviceSOFT(NULL);
    if(!dev) { fprintf(stderr, "alcLoopbackOpenDeviceSOFT failed\n"); return 1; }
    const int attrs[] = {ALC_FREQUENCY, rate,
                         ALC_FORMAT_CHANNELS_SOFT, ALC_STEREO_SOFT,
                         ALC_FORMAT_TYPE_SOFT, ALC_FLOAT_SOFT,
                         ALC_HRTF_SOFT, hrtf,
                         ALC_MONO_SOURCES, n_voices, 0};
    ALCcontext *ctx = alcCreateContext(dev, attrs);
    if(!ctx) { fprintf(stderr, "alcCreateContext failed\n"); return 1; }
    alcMakeContextCurrent(ctx);

    unsigned *bufs = malloc(sizeof(unsigned) * (size_t)n_tones);
    for(int i = 0; i < n_tones; ++i) {
        alGenBuffers(1, &bufs[i]);
        alBufferData(bufs[i], AL_FORMAT_MONO_FLOAT32,
                     tones + (size_t)i * tone_len, tone_len * 4, rate);
    }
    for(int v = 0; v < n_voices; ++v) {
        unsigned sid;
        alGenSources(1, &sid);
        alSourcei(sid, AL_BUFFER, (int)bufs[voices[v].tone]);
        alSourcei(sid, AL_LOOPING, 1);
        alSource3dSOFT(sid, AL_POSITION, voices[v].x, voices[v].y,
                       voices[v].z);
        if(voices[v].has_pitch)
            alSourcedSOFT(sid, AL_PITCH, voices[v].pitch);
        alSourcePlay(sid);
    }
    printf("BUILD_S=%.6f\n", now_s() - t0);

    FILE *out = fopen(argv[2], "wb");
    if(!out) { perror(argv[2]); return 2; }
    float *block = malloc(sizeof(float) * 2 * (size_t)frames);
    for(int c = 0; c < calls; ++c) {
        /* A render that fails leaves NaN behind, never stale frames. */
        for(size_t i = 0; i < 2 * (size_t)frames; ++i)
            block[i] = NAN;
        const double r0 = now_s();
        alcRenderSamplesSOFT(dev, block, frames);
        printf("RENDER_S=%.6f\n", now_s() - r0);
        if(fwrite(block, sizeof(float) * 2, (size_t)frames, out)
           != (size_t)frames) {
            perror(argv[2]);
            return 2;
        }
    }
    fclose(out);
    const int err = alGetError();
    printf("AL_ERROR=%d\n", err);
    fflush(stdout);
    free(block);
    free(bufs);
    free(voices);
    free(tones);
    return err == 0 ? 0 : 1;
}
